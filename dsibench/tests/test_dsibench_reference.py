"""The plain references against the port at smoke widths: the DPP
transform and load, the token packing, the decoder's loss and gradients,
and an import check of everything under dsibench."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

from dsibench import generate, harness  # noqa: E402
from dsibench import weights as W  # noqa: E402
from dsibench.reference import decoder_lm, dpp_transform  # noqa: E402
from dsibench.reference import tokens as ref_tokens  # noqa: E402
from dsibench.tests import smoke  # noqa: E402
from dsibench.tests.threads import share_cores  # noqa: E402

share_cores()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_under_dsibench_imports_jax_or_the_jax_package():
    files = sorted(harness.HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, (f, name)


def test_the_references_import_nothing_of_the_port():
    files = sorted((harness.HERE / "reference").glob("*.py"))
    files += [harness.HERE / "weights.py"]
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] != "repro_torch", (f, name)


def test_dpp_transform_matches_the_program():
    from repro_torch.core.schema import ColumnBatch, SparseColumn
    from repro_torch.core.transforms import (TransformPipeline, TransformSpec,
                                             materialize_dlrm_batch)

    model = harness.merged(harness.load_json("configs", "dlrm-paper"),
                           smoke.DLRM["config"])["model"]
    traffic = harness.merged(harness.load_json("traffic", "train.b4096"), smoke.DLRM["traffic"])
    _, plan, raws, dense_keys, sparse_keys = generate.dlrm_raws(model, traffic, smoke.SEED)
    pipe = TransformPipeline([TransformSpec(op, ins, out, tuple(
        (k, np.asarray(v) if k == "borders" else v) for k, v in params))
        for op, ins, out, params in plan])
    for raw in raws:
        batch = ColumnBatch(num_rows=len(raw["labels"]), dense=dict(raw["dense"]),
                            sparse={f: SparseColumn(offsets=o, values=v, scores=s)
                                    for f, (o, v, s) in raw["sparse"].items()},
                            labels=raw["labels"])
        want = materialize_dlrm_batch(pipe(batch), dense_keys, sparse_keys,
                                      model["max_ids_per_feature"], labels=raw["labels"])
        got = dpp_transform.transform(raw, plan, dense_keys, sparse_keys,
                                      model["max_ids_per_feature"])
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert got["sparse_mask"].sum() > 0


def test_token_packing_matches_the_program():
    from repro_torch.core import tokens as T

    traffic = dict(harness.load_json("traffic", "train.s512"), **smoke.LM_TRAFFIC)
    table, docs = generate.token_table(traffic, 512, smoke.SEED)
    got = list(T.lm_batches_from_table(table, 32, 4))
    want = ref_tokens.batches(docs, 32, 4)
    assert len(got) == len(want) > 10
    for g, (t, y) in zip(got, want):
        assert np.array_equal(g["tokens"], t) and np.array_equal(g["labels"], y)


def test_decoder_reference_matches_the_program_in_float32():
    from repro_torch.models import build_model

    from dsibench.runners import program_config

    config = harness.merged(harness.load_json("configs", "qwen3-8b"),
                            {"model": dict(smoke.LM_MODEL, param_dtype="float32",
                                           compute_dtype="float32")})
    m = config["model"]
    cfg = dataclasses.replace(program_config(config), remat=False)
    model = build_model(cfg, device="cpu")
    w = W.lm_weights(m, 5, "cpu", torch.float32)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(w[k])
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, 512, (2, 32)), dtype=torch.int32)
    labels = torch.as_tensor(rng.integers(0, 512, (2, 32)), dtype=torch.int32)
    params = dict(model.named_parameters())
    loss = model.loss({"tokens": tokens, "labels": labels})
    grads = torch.autograd.grad(loss, list(params.values()))
    ref = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref_loss = decoder_lm.Model(m, "float32").loss(ref, tokens, labels)
    ref_grads = torch.autograd.grad(ref_loss, [ref[k] for k in params])
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    for k, g, r in zip(params, grads, ref_grads):
        assert float(torch.linalg.vector_norm(g - r)) <= 1e-4 * float(
            torch.linalg.vector_norm(r)) + 1e-7, k
