"""The port's sharded DLRM step against the reference package.

The reference runs once, in a process of its own with eight virtual host
devices (``tests/torch_sharded_ref.py``): its vocab-sharded
``pooled_embeddings_sharded`` and ``sparse_table_update_sharded``, its
``_make_dlrm_sparse_train_step`` and its ``Trainer(mesh=...)`` on meshes
(1, 4), (2, 2) and (4, 1), built with Auto axes (on the Explicit axes
that ``jax.make_mesh`` builds by default the reference ``Trainer`` raises
in its first matmul).  The port runs the same inputs on four gloo ranks
started by ``repro_torch.distributed.spawn``, one group a mesh, on the
CPU (``tests/torch_sharded_ranks.py``); it also remeshes, and resumes a
step-3 checkpoint on another mesh.  One-device runs of both packages'
``Trainer`` (in this process) close the loop.  Inputs are drawn with
numpy from fixed seeds (``torch_sharded_ref.inputs``).  Tolerances:
pooled bags within rtol 1e-5 (float32 sums in another order), everything
after an update or a step within 1e-4.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import jax  # noqa: E402

import torch_sharded_ranks  # noqa: E402
import torch_sharded_ref as R  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import dlrm_params_from_numpy  # noqa: E402
from repro_torch.distributed import spawn as spawn_mod  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_init  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = configs.get_smoke_config("dlrm-paper")
CFG = dataclasses.replace(SMOKE, vocab_per_table=R.VOCAB)
FWD = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-6)
NEXT = {(1, 4): (2, 2), (2, 2): (1, 4), (4, 1): (2, 2)}
SPAWN_TIMEOUT_S = 60
REF_TIMEOUT_S = 120


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def ins():
    return R.inputs(SMOKE)


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    """The reference's run, started at once so that it overlaps the ranks."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH="src",
               XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_sharded_ref.py"),
                             str(path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    proc, path = ref_proc
    log, _ = proc.communicate(timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, log
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", params=list(NEXT), ids=lambda s: f"mesh{s[0]}x{s[1]}")
def port(request, ins, ref_proc, tmp_path_factory):
    """The four ranks' results on one mesh, in rank order."""
    shape = request.param
    tmp = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
    p0 = ins["params0"]
    mlp = {"bottom": p0["bottom"], "top": p0["top"]}
    zero_adam = {"mu": _zeros_like(mlp), "nu": _zeros_like(mlp), "step": np.int32(0)}
    dense0 = {"params": p0, "opt": {"mu": _zeros_like(p0), "nu": _zeros_like(p0),
                                    "step": np.int32(0)}, "step": 0}
    sparse0 = {"params": p0, "opt": {"adam": zero_adam,
                                     "acc": np.zeros(p0["tables"].shape[:2], np.float32)}}
    consts = {"vocab": R.VOCAB, "vocab_odd": R.VOCAB_ODD, "opt": R.OPT, "steps": R.STEPS,
              "batch": R.BATCH, "lr": R.LR}
    results = spawn_mod.spawn(
        torch_sharded_ranks.run_rank, 4, str(tmp / "rendezvous"), "gloo",
        args=(shape, NEXT[shape], ins, consts, dense0, sparse0, str(tmp / "ckpt")),
        timeout_s=SPAWN_TIMEOUT_S)
    return shape, results, str(tmp / "ckpt")


def _one_device_trainer(ins, steps):
    trainer = Trainer(CFG, OptimizerConfig(**R.OPT), TrainerConfig(max_steps=steps),
                      device="cpu")
    params = dlrm_params_from_numpy(ins["params0"])
    state = trainer.fit(ins["batches"][:steps],
                        {"params": params, "opt": adamw_init(params, OptimizerConfig(**R.OPT)),
                         "step": 0})
    return trainer, {k: v.numpy() for k, v in state["params"].items()}


@pytest.fixture(scope="module")
def one_device(ins):
    """The port's one-device Trainer after 3 and after 6 steps."""
    return {n: _one_device_trainer(ins, n) for n in (R.STEPS, 2 * R.STEPS)}


def _table_whole(results, get, coord="coord"):
    parts = {}
    for r in results:
        d, m = r[coord]
        a = get(r)
        if m in parts:
            np.testing.assert_array_equal(a, parts[m], err_msg=f"data replica {d}")
        parts[m] = a
    return np.concatenate([parts[m] for m in sorted(parts)], axis=1)


def _same_on_all(results, get):
    first = get(results[0])
    for r in results[1:]:
        np.testing.assert_array_equal(get(r), first)
    return first


@pytest.mark.parametrize("tag", ["ops", "odd", "edge"])
def test_pooled_embeddings_sharded(port, ref, tag):
    """vocab 1600 shards 4 or 2 ways; 1602 on a model axis of 4 falls back
    to the unsharded form, as in the reference; "edge" is
    ``torch_sharded_ref.edge_inputs``' batch (pads, a row named 10,000
    times, an all-pad bag, the last row)."""
    shape, results, _ = port
    got = _same_on_all(results, lambda r: r[tag]["pooled"])
    np.testing.assert_allclose(got, ref[f"{tag}/{shape}/pooled"], **FWD)


@pytest.mark.parametrize("tag", ["ops", "odd", "edge"])
def test_sparse_table_update_sharded(port, ref, ins, tag):
    """"edge" adds a d(pooled) row holding a NaN, whose pads reach row 0
    of table 4 on the first shard only, and lr as a 0-d tensor."""
    shape, results, _ = port
    v = R.VOCAB_ODD if tag == "odd" else R.VOCAB
    n = shape[1] if v % shape[1] == 0 else 1
    for r in results:
        assert r[tag]["lo"] == (r["coord"][1] * v // n if n > 1 else 0)
        assert r[tag]["kept"], "the functional form changed its inputs"
    tables = _table_whole(results, lambda r: r[tag]["tables"]) if n > 1 else \
        _same_on_all(results, lambda r: r[tag]["tables"])
    acc = _table_whole(results, lambda r: r[tag]["acc"]) if n > 1 else \
        _same_on_all(results, lambda r: r[tag]["acc"])
    np.testing.assert_allclose(tables, ref[f"{tag}/{shape}/tables"], **TOL)
    np.testing.assert_allclose(acc, ref[f"{tag}/{shape}/acc"], **TOL)
    # every rank's slice took part of the update
    changed = (tables != ins[tag]["tables"]).any(axis=(0, 2))
    assert all(part.any() for part in np.split(changed, n))


def test_sparse_train_step(port, ref):
    """3 steps of the port's sparse step against the reference's
    ``_make_dlrm_sparse_train_step`` on the same mesh."""
    shape, results, _ = port
    key = f"step/{shape}"
    for r in results:
        assert r["step"]["in_place"], "the step did not update the tables in place"
        np.testing.assert_allclose(r["step"]["loss"], ref[f"{key}/loss"], **TOL)
        np.testing.assert_allclose(r["step"]["grad_norm"], ref[f"{key}/grad_norm"], **TOL)
    assert results[0]["step"]["specs"][0] == "PartitionSpec('data',)"
    for name in results[0]["step"]["params"]:
        if name == "tables":
            continue
        got = _same_on_all(results, lambda r: r["step"]["params"][name])
        np.testing.assert_allclose(got, ref[f"{key}/params/{name}"], **TOL, err_msg=name)
    np.testing.assert_allclose(_table_whole(results, lambda r: r["step"]["params"]["tables"]),
                               ref[f"{key}/params/tables"], **TOL)
    np.testing.assert_allclose(_table_whole(results, lambda r: r["step"]["acc"]),
                               ref[f"{key}/acc"], **TOL)


def _check_trainer(results, part, want_loss, want_norm, want_params, coord="coord"):
    for r in results:
        np.testing.assert_allclose(r[part]["loss"], want_loss, **TOL)
        if want_norm is not None:
            np.testing.assert_allclose(r[part]["grad_norm"], want_norm, **TOL)
    for name, want in want_params.items():
        if name == "tables":
            got = _table_whole(results, lambda r: r[part]["params"]["tables"], coord)
        else:
            got = _same_on_all(results, lambda r: r[part]["params"][name])
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def test_trainer_on_mesh_matches_reference(port, ref):
    shape, results, _ = port
    key = f"trainer/{shape}"
    want = {k[len(key) + 8:]: v for k, v in ref.items() if k.startswith(f"{key}/params/")}
    _check_trainer(results, "trainer", ref[f"{key}/loss"], ref[f"{key}/grad_norm"], want)
    for moment in ("mu", "nu"):
        np.testing.assert_allclose(_table_whole(results, lambda r: r["trainer"][moment]["tables"]),
                                   ref[f"{key}/adamw/{moment}.tables"], **TOL)


def test_trainer_on_mesh_matches_one_device(port, one_device):
    _, results, _ = port
    trainer, params = one_device[R.STEPS]
    _check_trainer(results, "trainer", [h.loss for h in trainer.history],
                   [h.grad_norm for h in trainer.history], params)


def test_remesh_then_three_more_steps(port, one_device):
    """3 steps on the mesh, ``remesh`` to the next mesh over the same ranks,
    3 more: the last 3 steps and the weights equal 6 steps on one device."""
    _, results, _ = port
    trainer, params = one_device[2 * R.STEPS]
    for r in results:
        assert r["remesh"]["step"] == 2 * R.STEPS
    _check_trainer(results, "remesh", [h.loss for h in trainer.history[R.STEPS:]],
                   [h.grad_norm for h in trainer.history[R.STEPS:]], params, coord="coord2")


def test_checkpoint_resumes_on_another_mesh(port, one_device):
    _, results, _ = port
    trainer, params = one_device[2 * R.STEPS]
    for r in results:
        assert r["resumed"]["step"] == 2 * R.STEPS
        assert r["ckpt_steps"] == ["step_00000003"]
    _check_trainer(results, "resumed", [h.loss for h in trainer.history[R.STEPS:]],
                   [h.grad_norm for h in trainer.history[R.STEPS:]], params, coord="coord2")


def test_reference_trainer_resumes_port_mesh_checkpoint(port, one_device, ins):
    """The reference's one-device ``Trainer`` resumes the step-3 checkpoint
    the mesh wrote (whole tables, the reference's layout) and its 3 more
    steps equal the port's 6 on one device: losses within rtol 1e-4, each
    parameter within 1e-4 in relative norm.  Not element by element: the
    two packages sum in other orders for six steps, and AdamW divides each
    element's gradient by its own root mean square, so an element whose
    gradient is near zero moves by another fraction of the lr."""
    _, _, ckpt = port
    j_cfg = dataclasses.replace(jconfigs.get_smoke_config("dlrm-paper"),
                                vocab_per_table=R.VOCAB)
    trainer = JTrainer(j_cfg, JOptimizerConfig(**R.OPT),
                       JTrainerConfig(max_steps=2 * R.STEPS, checkpoint_dir=ckpt,
                                      checkpoint_every=100))
    state = trainer.fit(ins["batches"][R.STEPS:2 * R.STEPS], trainer.init_state(0))
    assert state["step"] == 2 * R.STEPS
    port_trainer, params = one_device[2 * R.STEPS]
    np.testing.assert_allclose([h.loss for h in trainer.history],
                               [h.loss for h in port_trainer.history[R.STEPS:]], **TOL)
    got = {k: np.asarray(v) for k, v in dlrm_params_from_numpy(
        jax.tree.map(np.asarray, state["params"])).items()}
    for name, want in params.items():
        rel = np.linalg.norm(got[name] - want) / np.linalg.norm(want)
        assert rel <= TOL["rtol"], (name, rel)
