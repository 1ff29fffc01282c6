"""Whole runs of each cell on the CPU at smoke sizes, past the harness's
look for a card: correct as the port stands, not correct with the timed
path broken underneath or with the control in the program's place."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

from dsibench import calibrate, harness  # noqa: E402
from dsibench.tests import smoke  # noqa: E402
from dsibench.tests.threads import share_cores  # noqa: E402

share_cores()


def run(cell, trace=False):
    return harness.run_cell(cell, smoke.SEED, 0.5, trace, device="cpu",
                            overrides=smoke.OVERRIDES[cell], log=lambda s: None)


@pytest.mark.parametrize("cell", smoke.CELLS)
def test_cell_runs_correct(cell):
    result, checks = run(cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in harness.metrics_of(harness.manifest(), cell, False)}
    assert set(result["metrics"]) == names - {"peak_device_gb"}
    assert list(result)[-1] == "checks"
    assert {n: v for n, v, _ in checks}["batches"] == 0


def test_traced_run_reads_the_per_layer_metrics():
    result, _ = run("dlrm-paper.train.b4096", trace=True)
    assert result["correct"]
    assert {"ingest_share.dlrm", "mfu.dlrm", "step_roofline_share.dlrm"} <= set(
        result["metrics"])
    assert all(0 < m["value"] < 100 for m in result["metrics"].values())


def _lm_unchanged(mp):
    from repro_torch.train.trainer import Trainer

    mp.setattr(Trainer, "_apply", lambda self, params, grads, opt, norm=None:
               (opt, torch.zeros(())))


def _lm_half_batch(mp):
    from repro_torch.models.transformer import DecoderLM

    loss = DecoderLM.loss
    mp.setattr(DecoderLM, "loss", lambda self, batch: loss(
        self, {k: v[:len(v) // 2] for k, v in batch.items()}))


def _lm_token(mp):
    from repro_torch.core import tokens as T

    pack = T.pack_sequences

    def altered(docs, seq_len, state=None):
        packed, state = pack(docs, seq_len, state)
        packed = packed.copy()
        if packed.size:
            packed[0, 1] += 1
        return packed, state

    mp.setattr(T, "pack_sequences", altered)


def _dlrm_unchanged(mp):
    from repro_torch.launch import steps
    from repro_torch.models.dlrm import DLRM

    mp.setattr(steps, "adamw_update", lambda p, g, s, c, norm=None, ndim=None:
               (p, s, torch.zeros(())))
    mp.setattr(DLRM, "sparse_table_update_sharded_", lambda *a, **k: None)


def _dlrm_half_batch(mp):
    from repro_torch.models.dlrm import DLRM

    loss = DLRM.loss_from_pooled

    def half(self, pooled, batch):
        n = pooled.shape[0] // 2
        return loss(self, pooled[:n], {k: v[:n] for k, v in batch.items()})

    mp.setattr(DLRM, "loss_from_pooled", half)


def _dlrm_answer(mp):
    from repro_torch.core.dpp import worker

    materialize = worker.materialize_dlrm_batch

    def altered(*a, **k):
        out = materialize(*a, **k)
        out["sparse_ids"] = np.array(out["sparse_ids"])
        out["sparse_ids"][0, 0, 0] += 1
        return out

    mp.setattr(worker, "materialize_dlrm_batch", altered)


FAULTS = {"qwen3-8b.train.s512": (_lm_unchanged, _lm_half_batch, _lm_token),
          "dlrm-paper.train.b4096": (_dlrm_unchanged, _dlrm_half_batch, _dlrm_answer)}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items())
                                        for f in fs], ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run(cell)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", smoke.CELLS)
def test_the_control_is_not_correct(cell):
    """The control in the precision below the cell's own (the LM's bf16,
    not the smoke runs' float32)."""
    dtypes = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
    over = harness.merged(smoke.OVERRIDES[cell], {"config": {"model": dtypes}}
                          if cell.startswith("qwen3") else {})
    numbers = calibrate.control_numbers(cell, smoke.SEED, "cpu", over)
    limits = harness.load_json("cells", cell)["limits"]
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import json, sys; sys.path[:0] = ['src', '.']\n"
            "from dsibench import harness\nfrom dsibench.tests import smoke\n"
            "c = 'qwen3-8b.train.s512'\n"
            "r, _ = harness.run_cell(c, 7, 0.2, False, device='cpu', "
            "overrides=smoke.OVERRIDES[c], log=lambda s: None)\n"
            "print(json.dumps([r['correct'], harness.loaded_forbidden()]))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == [True, []]
