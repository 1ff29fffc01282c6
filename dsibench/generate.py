"""The traffic generators: the raw data of each cell, made from ``--seed``.

Two sources, each read from a traffic file's parameters:

* ``dwrf_tokens``: a DWRF token corpus (documents of Zipf token ids and
  log-normal lengths), the LM cells' input, written into a warehouse
  table of the program;
* ``dwrf_dpp``: raw DLRM sample partitions (per-feature coverage, Poisson
  list lengths, Zipf ids, a CTR label rate) and the DPP session's
  transform plan, the DLRM cell's input.

The raw data are the benchmark's own and stay on the host beside the
table, so the plain reference reads them and nothing the program made.
Every seed gives the same sizes: the same number of partitions and
rows, and batches of the same shapes.

The document generator is a copy of ``repro_torch.core.tokens.
generate_documents``; the sample generator of ``repro_torch.core.datagen.
generate_partition``; the transform plan of ``repro_torch.core.transforms.
default_dlrm_pipeline`` and ``repro_torch.launch.train.dlrm_dpp_warehouse``
(there with fixed seeds), each seeded here from the run's seed.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# dwrf_tokens
# ---------------------------------------------------------------------------


def documents(n_docs: int, vocab_size: int, seed: int, partition: int,
              mean_len: float) -> Tuple[np.ndarray, np.ndarray]:
    """One partition's documents as CSR (offsets, int64 token ids):
    log-normal lengths in [16, 8 mean_len], Zipf ids in [1, vocab)."""
    rng = np.random.default_rng((seed, partition))
    lengths = np.clip(rng.lognormal(np.log(mean_len), 0.6, n_docs), 16,
                      8 * mean_len).astype(np.int64)
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    toks = (rng.zipf(1.3, int(offsets[-1])) % (vocab_size - 1) + 1).astype(np.int64)
    return offsets, toks


def token_docs(traffic: Dict[str, Any], vocab_size: int, seed: int
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The corpus's documents, (offsets, ids) a partition."""
    return [documents(traffic["docs_per_partition"], vocab_size, seed, p, traffic["mean_len"])
            for p in range(traffic["partitions"])]


def token_table(traffic: Dict[str, Any], vocab_size: int, seed: int):
    """(the corpus as a warehouse table of the program, its documents):
    ``partitions`` partitions of ``docs_per_partition`` documents,
    flattened DWRF in stripes of ``stripe_rows`` documents."""
    from repro_torch.core import dwrf
    from repro_torch.core import tokens as T
    from repro_torch.core.schema import ColumnBatch, SparseColumn
    from repro_torch.core.warehouse import Warehouse

    table = Warehouse().create_table(T.token_schema("lm_docs"))
    opts = dwrf.DwrfWriterOptions(flattened=True, stripe_rows=traffic["stripe_rows"])
    docs = token_docs(traffic, vocab_size, seed)
    for p, (off, toks) in enumerate(docs):
        batch = ColumnBatch(num_rows=len(off) - 1, dense={},
                            sparse={T.DOC_FEATURE_ID: SparseColumn(offsets=off, values=toks)})
        table.write_partition(p, batch, opts)
    return table, docs


# ---------------------------------------------------------------------------
# dwrf_dpp
# ---------------------------------------------------------------------------


def dlrm_plan(dense_fids: List[int], sparse_fids: List[int], hash_size: int, firstx: int,
              n_derived: int) -> List[Tuple[str, Tuple[str, ...], str, Tuple]]:
    """The DPP session's transform plan as plain data, (op, inputs,
    output, params) a step: dense features normalized (BoxCox, Logit,
    Clamp in turn), sparse ones cut to their first ``firstx`` ids and
    hashed into ``hash_size``, and ``n_derived`` generated features
    (NGram, Cartesian, Bucketize in turn)."""
    plan = []
    for i, fid in enumerate(dense_fids):
        op = ["BoxCox", "Logit", "Clamp"][i % 3]
        params = (("lo", -10.0), ("hi", 10.0)) if op == "Clamp" else ()
        plan.append((op, (f"f{fid}",), f"d{fid}", params))
    for fid in sparse_fids:
        plan.append(("FirstX", (f"f{fid}",), f"t{fid}", (("x", firstx),)))
        plan.append(("SigridHash", (f"t{fid}",), f"s{fid}",
                     (("salt", fid), ("max_value", hash_size))))
    sf = list(sparse_fids)
    for j in range(n_derived):
        if j % 3 == 0:
            plan.append(("NGram", (f"s{sf[j % len(sf)]}",), f"g{j}",
                         (("n", 2), ("mod", hash_size))))
        elif j % 3 == 1:
            plan.append(("Cartesian", (f"s{sf[j % len(sf)]}", f"s{sf[(j + 1) % len(sf)]}"),
                         f"g{j}", (("mod", hash_size),)))
        else:
            d = dense_fids[j % len(dense_fids)]
            plan.append(("Bucketize", (f"f{d}",), f"g{j}",
                         (("borders", tuple(np.linspace(-3, 3, 63).tolist())),)))
    return plan


def raw_partition(features, partition: int, rows: int, seed: int, label_rate: float,
                  zipf_a: float) -> Dict[str, Any]:
    """One partition of labelled samples as plain arrays: ``dense`` {fid:
    float32 (rows,), NaN where absent}, ``sparse`` {fid: (offsets, ids,
    scores or None)}, ``labels`` float32 (rows,)."""
    from repro_torch.core.schema import FeatureType

    rng = np.random.default_rng((seed, partition))
    dense, sparse = {}, {}
    for f in features:
        if not f.logged:
            continue
        present = rng.random(rows) < f.coverage
        if f.ftype == FeatureType.DENSE:
            col = rng.normal(0.0, 1.0, rows).astype(np.float32)
            col[~present] = np.nan
            dense[f.fid] = col
        else:
            lengths = np.where(present, np.clip(rng.poisson(f.avg_length, rows), 1,
                                                4 * int(f.avg_length) + 4), 0).astype(np.int64)
            offsets = np.zeros(rows + 1, np.int64)
            np.cumsum(lengths, out=offsets[1:])
            nnz = int(offsets[-1])
            ids = rng.zipf(zipf_a, nnz).astype(np.int64) % f.cardinality
            scores = (rng.random(nnz).astype(np.float32)
                      if f.ftype == FeatureType.SPARSE_SCORED else None)
            sparse[f.fid] = (offsets, ids, scores)
    labels = (rng.random(rows) < label_rate).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "labels": labels}


def dlrm_raws(model: Dict[str, Any], traffic: Dict[str, Any], seed: int):
    """(the warehouse table's schema, the transform plan, the raw
    partitions, the dense keys, the sparse keys).  The schema holds 3x the
    model's dense features and 3x its tables of sparse ones (a table holds
    more features than a model reads); the model reads the first
    ``num_dense`` dense ones, ``num_tables - num_tables // 4`` sparse ones
    and ``num_tables // 4`` generated ones.  Each of ``pool`` partitions
    holds one batch of rows."""
    from repro_torch.core.schema import make_schema

    n_dense, n_tables = model["num_dense"], model["num_tables"]
    schema = make_schema("dlrm_table", n_dense=n_dense * 3, n_sparse=max(n_tables * 3, 8),
                         seed=0)
    features = list(schema.features.values())
    n_gen = n_tables // 4
    dense = schema.dense_ids[:n_dense]
    sparse = schema.sparse_ids[:n_tables - n_gen]
    plan = dlrm_plan(dense, sparse, model["vocab_per_table"], model["max_ids_per_feature"],
                     n_gen)
    raws = [raw_partition(features, p, traffic["batch"], seed, traffic["label_rate"],
                          traffic["zipf_a"]) for p in range(traffic["pool"])]
    return (schema, plan, raws, tuple(f"d{f}" for f in dense),
            tuple(f"s{f}" for f in sparse) + tuple(f"g{j}" for j in range(n_gen)))


def dpp_inputs(model: Dict[str, Any], traffic: Dict[str, Any], seed: int):
    """The DLRM cell's warehouse table, the DPP session spec (one split a
    partition), the raw partitions and the transform plan."""
    from repro_torch.core import dwrf
    from repro_torch.core.dpp import SessionSpec
    from repro_torch.core.schema import ColumnBatch, SparseColumn
    from repro_torch.core.transforms import TransformSpec
    from repro_torch.core.warehouse import Warehouse

    schema, plan, raws, dense_keys, sparse_keys = dlrm_raws(model, traffic, seed)
    rows = traffic["batch"]
    table = Warehouse().create_table(schema)
    opts = dwrf.DwrfWriterOptions(flattened=True, stripe_rows=traffic["stripe_rows"])
    for p, raw in enumerate(raws):
        batch = ColumnBatch(
            num_rows=rows, dense=dict(raw["dense"]),
            sparse={f: SparseColumn(offsets=o, values=v, scores=s)
                    for f, (o, v, s) in raw["sparse"].items()},
            labels=raw["labels"])
        table.write_partition(p, batch, opts)
    specs = tuple(TransformSpec(op, ins, out, tuple((k, np.asarray(v) if k == "borders" else v)
                                                    for k, v in params))
                  for op, ins, out, params in plan)
    required = sorted({int(i[1:]) for _, ins, _, _ in plan for i in ins
                       if i.startswith("f")})
    spec = SessionSpec(
        table=schema.name, partitions=tuple(range(traffic["pool"])),
        feature_ids=tuple(required), transform_specs=specs, batch_size=rows,
        rows_per_split=rows, dense_keys=dense_keys, sparse_keys=sparse_keys,
        max_ids_per_feature=model["max_ids_per_feature"])
    return table, spec, raws, plan
