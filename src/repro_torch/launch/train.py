"""The port's DPP serving entry point: warehouse -> DPP -> tensor batches.

``dlrm_dpp_batches`` builds a synthetic warehouse and a DPP session the
way the reference's ``repro.launch.train.dlrm_dpp_batches`` does, and
yields the tensor batches a trainer's client would consume.  The DLRM
model and trainer are not ported yet, so it takes the model's data-path
widths as plain ints; the defaults are the ``dlrm-paper`` configuration
(the reference's ``configs/dlrm_paper.py``).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.core import dwrf
from repro_torch.core.datagen import DataGenConfig
from repro_torch.core.dpp import DPPSession, SessionSpec
from repro_torch.core.schema import make_schema
from repro_torch.core.transforms import default_dlrm_pipeline
from repro_torch.core.warehouse import Table, Warehouse

# dlrm-paper's data-path widths (RM3-like scale, Table 4)
DLRM_PAPER_NUM_DENSE = 504
DLRM_PAPER_NUM_TABLES = 42
DLRM_PAPER_VOCAB_PER_TABLE = 2_000_000
DLRM_PAPER_MAX_IDS_PER_FEATURE = 32


def dlrm_dpp_table(
    batch_size: int,
    num_dense: int = DLRM_PAPER_NUM_DENSE,
    num_tables: int = DLRM_PAPER_NUM_TABLES,
    vocab_per_table: int = DLRM_PAPER_VOCAB_PER_TABLE,
    max_ids_per_feature: int = DLRM_PAPER_MAX_IDS_PER_FEATURE,
    n_partitions: int = 2,
    rows_per_partition: int = 2048,
) -> Tuple[Table, SessionSpec]:
    """The synthetic warehouse table and the DPP session spec that
    ``dlrm_dpp_batches`` serves."""
    schema = make_schema("dlrm_table", n_dense=num_dense * 3,
                         n_sparse=max(num_tables * 3, 8), seed=0)
    wh = Warehouse()
    table = wh.create_table(schema)
    table.generate(
        n_partitions,
        DataGenConfig(rows_per_partition=rows_per_partition, seed=1),
        dwrf.DwrfWriterOptions(flattened=True, stripe_rows=512),
    )
    dense = schema.dense_ids[:num_dense]
    n_gen = max(num_tables // 4, 0)
    sparse = schema.sparse_ids[: num_tables - n_gen]
    pipe = default_dlrm_pipeline(
        dense, sparse, hash_size=vocab_per_table,
        firstx=max_ids_per_feature, n_derived=n_gen,
    )
    spec = SessionSpec(
        table=schema.name,
        partitions=tuple(range(n_partitions)),
        feature_ids=tuple(pipe.required_features()),
        transform_specs=tuple(pipe.specs),
        batch_size=batch_size,
        rows_per_split=512,
        dense_keys=tuple(f"d{f}" for f in dense),
        sparse_keys=tuple(f"s{f}" for f in sparse) + tuple(f"g{j}" for j in range(n_gen)),
        max_ids_per_feature=max_ids_per_feature,
    )
    return table, spec


def dlrm_dpp_batches(
    batch_size: int,
    num_dense: int = DLRM_PAPER_NUM_DENSE,
    num_tables: int = DLRM_PAPER_NUM_TABLES,
    vocab_per_table: int = DLRM_PAPER_VOCAB_PER_TABLE,
    max_ids_per_feature: int = DLRM_PAPER_MAX_IDS_PER_FEATURE,
    n_partitions: int = 2,
    rows_per_partition: int = 2048,
    n_workers: int = 2,
    device: str = "cuda",
    engine: str = "torch",
    decode_engine: str = "torch",
) -> Tuple[Iterator[Dict[str, np.ndarray]], DPPSession]:
    """Build a synthetic warehouse + DPP session; yield tensor batches.

    ``engine``/``decode_engine`` pick the transform and extract engines
    (``"torch"`` on ``device``, or the ``"numpy"`` reference); every
    choice yields byte-identical batches."""
    table, spec = dlrm_dpp_table(
        batch_size, num_dense, num_tables, vocab_per_table,
        max_ids_per_feature, n_partitions, rows_per_partition,
    )
    session = DPPSession(spec, table, n_workers=n_workers, auto_scale=True,
                         engine=engine, decode_engine=decode_engine, device=device)
    session.start()

    def gen():
        while True:
            b = session.clients[0].get_batch(timeout=5.0)
            if b is None:
                if session.master.finished and all(w.buffered == 0 for w in session.workers):
                    session.stop()
                    return
                continue
            yield b

    return gen(), session
