"""The port's sharded LM steps (``repro_torch.launch.steps``) against the
reference's on a mesh.

The reference runs once, in a process of its own with four virtual host
devices and Auto axes (``tests/torch_steps_ref.py``, started first so it
overlaps the ranks): ``make_train_step`` for ``deepseek-smoke`` (8
experts, remat on: ``moe_forward_ep`` recomputed in the backward) and
``qwen3-smoke`` in float32 on meshes (2, 2) and (1, 4), 2 steps each;
``make_prefill_step`` and ``make_decode_step`` for deepseek on (2, 2);
and ``jax.grad`` through ``moe_forward_ep`` on both meshes.  The port
runs in one ``spawn`` of four gloo CPU ranks (``tests/torch_steps_ranks.py``)
from the same numpy inputs: the same steps, the expert-parallel backward,
the serving steps, and ``Trainer(mesh=...)`` on qwen3 then ``remesh``.

Bounds: losses and grad norms within 1e-5 (relative) at step 1 and 1e-4
at step 2, every rank's updated slices within 1e-4 of the reference's
(float32 sums in another order, and the updates of an AdamW step bounded
by its lr); the reference's (2, 2) MoE loss carries data shard 0's aux
loss where the port reports the shards' mean (the reference's gradients
are the mean's), so that loss is compared after putting the mean in.
No top-k margin of the routed tokens is under 1e-5, so both packages
route alike.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import torch_moe_ref as MR  # noqa: E402
import torch_steps_ranks  # noqa: E402
import torch_steps_ref as R  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.distributed import spawn as spawn_mod  # noqa: E402
from repro_torch.distributed.sharding import P, shard_leaf  # noqa: E402
from repro_torch.models import build_model, moe as moe_lib  # noqa: E402
from repro_torch.models.transformer import AUX_LOSS_COEF  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240
REF_TIMEOUT_S = 240
LOSS_RTOL = (1e-5, 1e-4)          # step 1, step 2
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-5
MESHES = [tuple(s) for s in R.MESHES]


class StubMesh:
    def __init__(self, shape, coord):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self._coord = dict(zip(self.axis_names, coord))

    def coord(self, axis):
        return self._coord[axis]


def _inputs():
    import jax.numpy as jnp

    ins = {}
    for arch in R.ARCHS:
        cfg = R.smoke(jconfigs.get_smoke_config, arch, jnp.float32)
        ins[arch] = {"params0": R.draw_params(j_build_model(cfg).abstract(), 11),
                     "batches": R.batches(cfg.vocab_size, 13)}
    params, x = MR.inputs()
    ins.update(ep_params=params, ep_x=x, ep_cot=R.ep_cotangent())
    return ins


@pytest.fixture(scope="module")
def ins():
    return _inputs()


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    path = tmp_path_factory.mktemp("steps_ref") / "ref.npz"
    # one thread for XLA's own work: the ranks run beside it, and the suite
    # runs this file beside five others
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_steps_ref.py"),
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


@pytest.fixture(scope="module")
def port(ins, ref, tmp_path_factory):
    """Every rank's results on every mesh, in rank order.  The decode
    step's cache is the reference's prefill cache, padded: both packages
    decode from one state."""
    cfg = R.smoke(jconfigs.get_smoke_config, R.ARCHS[0], np.float32)
    long = {}
    for k in ("c_kv", "k_rope"):
        c = ref[f"serve/prefill_cache/{k}"]
        pad = np.zeros(c.shape[:2] + (R.DECODE_EXTRA,) + c.shape[3:], np.float32)
        long[k] = np.concatenate([c, pad], axis=2)
    ins = dict(ins, serve=dict(R.serve_inputs(cfg.vocab_size), long_cache=long))
    tmp = tmp_path_factory.mktemp("steps_ranks")
    consts = {"meshes": MESHES, "archs": R.ARCHS, "B": R.B, "S": R.S, "opt": R.OPT,
              "decode_extra": R.DECODE_EXTRA, "aux_coef": R.AUX_COEF,
              "ep_cfg": MR.CFG, "ep_moe": MR.MOE, "ckpt_dir": str(tmp / "ckpt")}
    return spawn_mod.spawn(torch_steps_ranks.run_rank, 4, str(tmp / "rendezvous"), "gloo",
                           args=(ins, consts), timeout_s=SPAWN_TIMEOUT_S)


def _ref_params(ref, arch, shape, step):
    prefix = f"{arch}/{shape}/step{step}/"
    tree = {}
    for k, v in ref.items():
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return {k: t.numpy() for k, t in lm_params_from_numpy(tree).items()}


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_train_step_matches_reference(arch, shape, port, ref):
    """Losses and grad norms of 2 steps, and every rank's slices after
    each, against the reference's ``make_train_step`` on the same mesh;
    slices updated in place and replicated slices bit-identical across
    the ranks that hold them."""
    tag = f"{arch}/{shape}"
    want_loss = ref[f"{tag}/loss"].copy()
    if f"{tag}/aux" in ref:         # the reference reports data shard 0's aux
        aux = ref[f"{tag}/aux"]
        want_loss += AUX_LOSS_COEF * (aux.mean(axis=1) - aux[:, 0])
    for r in port:
        out = r[shape][arch]
        assert out["in_place"] and out["mu_specs_same"]
        for i, rtol in enumerate(LOSS_RTOL):
            np.testing.assert_allclose(out["loss"][i], want_loss[i], rtol=rtol)
            np.testing.assert_allclose(out["grad_norm"][i], ref[f"{tag}/grad_norm"][i],
                                       rtol=rtol)
        mesh = StubMesh(shape, r[shape]["coord"])
        for step in (1, 2):
            want = _ref_params(ref, arch, shape, step)
            got = out["params"][step - 1]
            assert set(got) == set(want)
            for k, spec in out["specs"].items():
                np.testing.assert_allclose(got[k], shard_leaf(want[k], P(*spec), mesh),
                                           err_msg=f"{k} step {step}", **PARAM_TOL)
    # the ranks that hold one slice hold it bit for bit
    held = {}
    for r in port:
        out = r[shape][arch]
        coord = dict(zip(("data", "model"), r[shape]["coord"]))
        for k, spec in out["specs"].items():
            used = {a for ax in spec if ax for a in ((ax,) if isinstance(ax, str) else ax)}
            key = (k, tuple(coord[a] for a in sorted(used)))
            a = out["params"][-1][k]
            if key in held:
                assert a.tobytes() == held[key].tobytes(), k
            held[key] = a


@pytest.mark.parametrize("arch", R.ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_collectives_equal_the_dry_run(arch, shape, port):
    """Step 1's collectives on each gloo rank (kind, result bytes, axis and
    group, in order) equal those of the same step dry-run on ``meta`` over
    a ``VirtualMesh`` at the rank's coordinate."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import trace
    from repro_torch.launch.mesh import VirtualMesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptimizerConfig

    cfg = torch_steps_ranks.smoke(arch)
    for r in port:
        mesh = VirtualMesh(shape, ("data", "model"), coord=r[shape]["coord"])
        bundle = make_train_step(cfg, mesh, R.B, R.S, opt_cfg=OptimizerConfig(**R.OPT),
                                 device="meta")
        spec = configs.ShapeSpec("steps", R.S, R.B, "train")
        tr = trace(bundle.fn, *dryrun.lm_args(bundle, spec))
        want = [(c.kind, c.nbytes, c.axis, c.group) for c in tr.collectives]
        got = [tuple(c) for c in r[shape][arch]["collectives"]]
        assert got == want
        assert {k for k, *_ in got} == {"all-gather", "all-reduce"}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_experts_are_sliced_over_model(shape, port):
    """Each rank holds its ``expert_rows`` of the deepseek expert leaves
    (the expert axis on "model"), qwen3 none."""
    n_model = shape[1]
    for r in port:
        out = r[shape]["deepseek-v2-236b"]
        names = out["expert"]
        assert len(names) == 3 * 2 and all(k.split(".")[-1] in ("wi_gate", "wi_up", "wo")
                                           for k in names)
        for k in names:
            assert out["specs"][k][0] == "model"
            assert out["params"][0][k].shape[0] == 8 // n_model
        assert r[shape]["qwen3-8b"]["expert"] == []


def _route_margins(ins, params):
    """The smallest gap between the k-th and (k+1)-th router probability
    over the tokens of every batch, on one device (float32, CPU)."""
    cfg = torch_steps_ranks.smoke(R.ARCHS[0])
    model = build_model(cfg, device="cpu")
    margins = []
    real = moe_lib.route

    def route(router_w, x, m):
        probs = torch.softmax(x.to(m.router_dtype) @ router_w, dim=-1)
        top = torch.topk(probs, m.top_k + 1, dim=-1).values
        margins.append(float((top[:, -2] - top[:, -1]).min()))
        return real(router_w, x, m)

    moe_lib.route = route
    try:
        for p, b in zip(params, ins[R.ARCHS[0]]["batches"]):
            model.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
            with torch.no_grad():
                model.loss({k: torch.from_numpy(v) for k, v in b.items()})
    finally:
        moe_lib.route = real
    return min(margins)


def test_routing_margins_clear_of_rounding(ins, ref):
    """The deepseek data: no top-k margin under 1e-5, at the parameters
    of step 1 and of step 2 (the reference's, on (1, 4))."""
    params = [{k: t.numpy() for k, t in lm_params_from_numpy(
        ins[R.ARCHS[0]]["params0"]).items()}, _ref_params(ref, R.ARCHS[0], (1, 4), 1)]
    assert _route_margins(ins, params) > MARGIN


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_expert_parallel_backward_matches_reference(shape, port, ref):
    """``moe_forward_ep`` under autograd on gloo ranks: the router and
    shared-expert gradients equal on every "model" rank and, summed over
    the data ranks, the reference's ``jax.grad``; each rank's expert
    slices' summed likewise; x's of each data shard's rows."""
    n_data, n_model = shape
    router = {}
    experts = {k: np.zeros_like(ref[f"ep/{shape}/{k}"]) for k in ("wi_gate", "wi_up", "wo")}
    x = np.zeros_like(ref[f"ep/{shape}/x"])
    for r in port:
        e = r[shape]["ep"]
        d, m = r[shape]["coord"]
        lo, hi = e["experts"]
        assert (lo, hi) == (m * 8 // n_model, (m + 1) * 8 // n_model)
        for k in ("wi_gate", "wi_up", "wo"):
            experts[k][lo:hi] += e[k]
        for k in ("router", "shared.wi_gate", "shared.wi_up", "shared.wo"):
            if (d, k) in router:
                if m != router[(d, k)][0]:
                    np.testing.assert_array_equal(e[k], router[(d, k)][1])
            else:
                router[(d, k)] = (m, e[k])
        if m == 0:
            x[e["rows"][0]:e["rows"][1]] = e["x"]
    for k in ("router", "shared.wi_gate", "shared.wi_up", "shared.wo"):
        got = sum(router[(d, k)][1] for d in range(n_data))
        np.testing.assert_allclose(got, ref[f"ep/{shape}/{k}"], err_msg=k, **GRAD_TOL)
    for k, g in experts.items():
        np.testing.assert_allclose(g, ref[f"ep/{shape}/{k}"], err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(x, ref[f"ep/{shape}/x"], **GRAD_TOL)


def test_prefill_and_decode_match_reference(port, ref):
    """deepseek on (2, 2): each rank's prefill logits and cache equal the
    reference's rows; the decode step (the cache split over "model" along
    its sequence, gathered for the step and cut again, in place) its rows'
    logits and its slice of the written cache."""
    shape = MESHES[0]
    for r in port:
        s = r[shape]["serve"]
        d, m = r[shape]["coord"]
        rows = slice(d * R.B // shape[0], (d + 1) * R.B // shape[0])
        assert len(s["expert"]) == 6
        np.testing.assert_allclose(s["prefill_logits"], ref["serve/prefill_logits"][rows],
                                   **SERVE_TOL)
        for k, v in s["prefill_cache"].items():
            np.testing.assert_allclose(v, ref[f"serve/prefill_cache/{k}"][:, rows], **SERVE_TOL)
        np.testing.assert_allclose(s["decode_logits"], ref["serve/decode_logits"][rows],
                                   **SERVE_TOL)
        assert s["decode_in_place"]
        mesh = StubMesh(shape, (d, m))
        for k, v in s["decode_cache"].items():
            spec = s["decode_specs"][k]
            assert spec == (None, "data", "model")
            np.testing.assert_allclose(
                v, shard_leaf(ref[f"serve/decode_cache/{k}"], P(*spec), mesh), **SERVE_TOL)


def test_trainer_on_mesh_trains_an_lm(port, ref):
    """``Trainer(mesh=...)`` on qwen3-smoke (2, 2) takes the reference's
    steps; ``remesh`` to (1, 4) gives each rank its slices of the same
    parameters, and so does a trainer on (1, 4) resuming the checkpoint
    the (2, 2) one wrote whole; ``init_state`` draws slices of the rules'
    shapes."""
    shape, nxt = MESHES
    arch = R.ARCHS[1]
    for r in port:
        t = r[shape]["trainer"]
        assert t["step"] == R.STEPS
        for i, rtol in enumerate(LOSS_RTOL):
            np.testing.assert_allclose(t["loss"][i], ref[f"{arch}/{shape}/loss"][i], rtol=rtol)
            np.testing.assert_allclose(t["grad_norm"][i], ref[f"{arch}/{shape}/grad_norm"][i],
                                       rtol=rtol)
        want = _ref_params(ref, arch, shape, R.STEPS)
        specs = t["specs"]
        here = StubMesh(shape, r[shape]["coord"])
        there = StubMesh(nxt, t["next_coord"])
        for k in want:
            np.testing.assert_allclose(t["params"][k], shard_leaf(want[k], P(*specs[k]), here),
                                       err_msg=k, **PARAM_TOL)
            np.testing.assert_allclose(t["remeshed"][k],
                                       shard_leaf(want[k], P(*t["next_specs"][k]), there),
                                       err_msg=k, **PARAM_TOL)
            assert t["remeshed_mu"][k].shape == t["remeshed"][k].shape
            assert t["init_shapes"][k] == t["remeshed"][k].shape
            np.testing.assert_array_equal(t["resumed"][k], t["remeshed"][k], err_msg=k)
            np.testing.assert_array_equal(t["resumed_mu"][k], t["remeshed_mu"][k], err_msg=k)
        assert t["resumed_step"] == R.STEPS
