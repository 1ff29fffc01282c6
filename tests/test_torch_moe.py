"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe``.

The four tests of ``tests/test_moe.py`` on the port, then ``route``,
``_capacity`` and ``moe_forward`` held to the reference's on the same
inputs, made with numpy from a seed: float32 and bf16, ample and tight
capacity, with and without shared experts.  Routing must agree exactly
(the expert indices equal), so every input asserts that no token's k-th
and (k+1)-th router probabilities lie within ``TIE_MARGIN`` of each
other: a tie could flip a choice between the frameworks.  Then the
expert-parallel forward on gloo ranks (``repro_torch.distributed.spawn``,
``tests/torch_moe_ranks.py``) on meshes (1, 2), (1, 4) and (2, 2),
against the reference's ``moe_forward_ep`` on the same meshes of virtual
host devices with Auto axes (``tests/torch_moe_ref.py``, in a process of
its own) and against the port's one-rank forward.
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
import jax.numpy as jnp  # noqa: E402

import torch_moe_ranks  # noqa: E402
import torch_moe_ref as R  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402
from repro.models.common import MoEConfig as JMoEConfig  # noqa: E402
from repro.models.common import init_params  # noqa: E402
from repro_torch.convert import moe_shard_from_numpy  # noqa: E402
from repro_torch.distributed import spawn as spawn_mod  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.common import ModelConfig, MoEConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
TIE_MARGIN = 1e-5
ROUTE_TOL = 1e-6          # gates and aux: the same float32 softmax in both
# moe_forward: float32 differs by the order of sums only; bf16 by where the
# two frameworks round the expert products (one bf16 ulp is 2^-8 relative)
FWD_TOL = {"f32": 1e-5, "bf16": 2e-2}
EP_TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT_S = 90
REF_TIMEOUT_S = 120


def _cfgs(e=4, k=2, dff=32, d=16, dtype="f32", **moe):
    """The reference test's config (``tests/test_moe.py::_cfg``) in both
    packages."""
    td, jd = DTYPES[dtype]
    fields = dict(name="t", family="moe", num_layers=1, d_model=d, num_heads=2,
                  num_kv_heads=2, d_ff=dff, vocab_size=64, head_dim=8)
    m = dict(num_experts=e, top_k=k, d_ff=dff, capacity_factor=8.0, **moe)
    return (ModelConfig(**fields, moe=MoEConfig(**m), param_dtype=td, compute_dtype=td),
            JModelConfig(**fields, moe=JMoEConfig(**m), param_dtype=jd, compute_dtype=jd))


def _params(jcfg, seed=0):
    """The reference's initial parameters (numpy leaves) and the port's copy."""
    jp = jax.tree.map(np.asarray, init_params(JM.moe_specs(jcfg), jax.random.PRNGKey(seed)))
    return jp, moe_shard_from_numpy(jp, None)


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    td, jd = DTYPES[dtype]
    return torch.from_numpy(x).to(td), jnp.asarray(x, jd)


def _assert_no_ties(router, x, k):
    """No token's k-th and (k+1)-th router probabilities within TIE_MARGIN."""
    p = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ router.float(), dim=-1)
    top = torch.topk(p, min(k + 1, p.shape[-1]), dim=-1).values
    if top.shape[-1] > k:
        margin = float((top[:, k - 1] - top[:, k]).min())
        assert margin > TIE_MARGIN, f"a near tie in the test data: margin {margin}"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# -- the reference's four tests, on the port ---------------------------------------


def _dense_moe(params, x, m):
    """Every expert run densely, combined by the gates (the reference
    test's oracle, in PyTorch)."""
    idx, gates, _ = M.route(params["router"], x, m)
    outs = torch.stack([(torch.nn.functional.silu(x @ params["wi_gate"][e])
                         * (x @ params["wi_up"][e])) @ params["wo"][e]
                        for e in range(m.num_experts)], 1)                  # (T, E, d)
    w = torch.einsum("tke,tk->te", torch.nn.functional.one_hot(idx, m.num_experts)
                     .to(x.dtype), gates)
    return torch.einsum("te,ted->td", w, outs)


def test_moe_matches_dense_reference_with_ample_capacity():
    cfg, jcfg = _cfgs()
    jp, p = _params(jcfg)
    x, jx = _x((2, 8, cfg.d_model), "f32", 1)
    _assert_no_ties(p["router"], x, cfg.moe.top_k)
    y, aux = M.moe_forward(p, x, cfg)
    want = _dense_moe(p, x.reshape(-1, cfg.d_model), cfg.moe).reshape(x.shape)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-4)
    assert float(aux) > 0
    jy, jaux = JM.moe_forward(jp, jx, jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=FWD_TOL["f32"],
                               atol=FWD_TOL["f32"])
    assert abs(float(aux) - float(jaux)) <= ROUTE_TOL


def test_capacity_dropping_bounds_tokens():
    cfg, jcfg = _cfgs()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=0.25))
    jp, p = _params(jcfg)
    x, jx = _x((4, 16, cfg.d_model), "f32", 2)
    _assert_no_ties(p["router"], x, cfg.moe.top_k)
    y, _ = M.moe_forward(p, x, cfg)
    assert torch.isfinite(y).all()
    # 64 tokens x 2 slots over 4 experts of capacity 8: most slots drop,
    # and a token whose both slots dropped gets exactly 0
    dropped = (y.reshape(-1, cfg.d_model) == 0).all(dim=-1)
    assert dropped.any() and not dropped.all()
    jy, _ = JM.moe_forward(jp, jx, jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=FWD_TOL["f32"],
                               atol=FWD_TOL["f32"])


def test_shared_experts_added():
    cfg, jcfg = _cfgs(num_shared_experts=1, shared_d_ff=32)
    jp, p = _params(jcfg)
    x, _ = _x((2, 4, cfg.d_model), "f32", 3)
    y, _ = M.moe_forward(p, x, cfg)
    p2 = dict(p, shared={k: torch.zeros_like(v) for k, v in p["shared"].items()})
    y2, _ = M.moe_forward(p2, x, cfg)
    assert float((y - y2).abs().max()) > 1e-6


def test_router_gates_normalized():
    cfg, jcfg = _cfgs()
    jp, p = _params(jcfg)
    x, jx = _x((32, cfg.d_model), "f32", 4)
    _assert_no_ties(p["router"], x, cfg.moe.top_k)
    idx, gates, aux = M.route(p["router"], x, cfg.moe)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-5)
    assert int(idx.max()) < cfg.moe.num_experts
    jidx, jgates, jaux = JM.route(jnp.asarray(jp["router"]), jx, jcfg.moe)
    assert idx.numpy().tolist() == np.asarray(jidx).tolist()
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=0, atol=ROUTE_TOL)
    assert abs(float(aux) - float(jaux)) <= ROUTE_TOL


# -- against the reference -----------------------------------------------------------


@pytest.mark.parametrize("tokens", [1, 7, 8, 64, 1000, 4096])
@pytest.mark.parametrize("moe", [dict(num_experts=4, top_k=2, capacity_factor=1.25),
                                 dict(num_experts=160, top_k=6, capacity_factor=1.25),
                                 dict(num_experts=384, top_k=8, capacity_factor=0.25)])
def test_capacity_matches_reference(tokens, moe):
    m = MoEConfig(d_ff=8, **moe)
    assert M._capacity(tokens, m) == JM._capacity(tokens, JMoEConfig(d_ff=8, **moe))
    assert M._capacity(tokens, m) % 8 == 0 and M._capacity(tokens, m) >= 8


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_route_matches_reference(dtype):
    """Indices equal; gates within 1e-6 (bf16: one bf16 rounding of the
    same float32 gates, so within one ulp) and aux within 1e-6."""
    cfg, jcfg = _cfgs(e=8, k=3, d=32, dtype=dtype)
    jp, p = _params(jcfg, seed=5)
    x, jx = _x((64, cfg.d_model), dtype, 6)
    _assert_no_ties(p["router"], x, cfg.moe.top_k)
    idx, gates, aux = M.route(p["router"], x, cfg.moe)
    jidx, jgates, jaux = JM.route(jnp.asarray(jp["router"]), jx, jcfg.moe)
    assert gates.dtype == DTYPES[dtype][0]
    assert idx.numpy().tolist() == np.asarray(jidx).tolist()
    tol = ROUTE_TOL if dtype == "f32" else 2 ** -8
    np.testing.assert_allclose(_np(gates), _np(jgates), rtol=tol, atol=ROUTE_TOL)
    assert abs(float(aux) - float(jaux)) <= ROUTE_TOL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["ample", "tight", "shared", "tight_shared"])
def test_moe_forward_matches_reference(case, dtype):
    """y within FWD_TOL of the reference's (relative and absolute), aux
    within 1e-6: ample capacity (8.0), tight (0.25: most slots dropped),
    and a shared expert beside either."""
    cf = 0.25 if case.startswith("tight") else 8.0
    extra = dict(num_shared_experts=2, shared_d_ff=24) if case.endswith("shared") else {}
    cfg, jcfg = _cfgs(e=8, k=2, dff=32, d=32, dtype=dtype, **extra)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    jp, p = _params(jcfg, seed=7)
    x, jx = _x((3, 20, cfg.d_model), dtype, 8)
    _assert_no_ties(p["router"], x, cfg.moe.top_k)
    y, aux = M.moe_forward(p, x, cfg)
    jy, jaux = JM.moe_forward(jax.tree.map(jnp.asarray, jp), jx, jcfg)
    assert y.dtype == DTYPES[dtype][0] and y.shape == x.shape
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(_np(y), _np(jy), rtol=tol, atol=tol)
    assert abs(float(aux) - float(jaux)) <= ROUTE_TOL
    if cf < 1 and not extra:      # some token lost both of its slots
        assert (y.reshape(-1, cfg.d_model).float() == 0).all(-1).any()


def test_moe_forward_takes_a_module():
    """The model's FFN module (parameters and the ``shared`` submodule)
    gives what the dict of the same leaves gives."""
    from repro_torch.models.common import module_from_specs

    cfg, jcfg = _cfgs(num_shared_experts=1, shared_d_ff=16)
    jp, p = _params(jcfg)
    mod = module_from_specs(M.moe_specs(cfg), torch.device("cpu"))
    with torch.no_grad():
        for name, t in p.items():
            if isinstance(t, dict):
                for k, v in t.items():
                    getattr(mod.shared, k).copy_(v)
            else:
                getattr(mod, name).copy_(t)
    x, _ = _x((2, 5, cfg.d_model), "f32", 9)
    with torch.no_grad():
        assert torch.equal(M.moe_forward(mod, x, cfg)[0], M.moe_forward(p, x, cfg)[0])


def test_moe_specs_match_reference():
    """Shapes, dtypes, initializers and logical axes leaf by leaf."""
    cfg, jcfg = _cfgs(num_shared_experts=2, shared_d_ff=48)
    got = M.moe_specs(cfg)
    want = JM.moe_specs(jcfg)
    flat = lambda t, pre="": {f"{pre}{k}": v for kk, vv in t.items()  # noqa: E731
                               for k, v in (flat(vv, f"{kk}.").items() if isinstance(vv, dict)
                                            else [(kk, vv)])}
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name].shape == w[name].shape, name
        assert g[name].logical == w[name].logical, name
        assert g[name].init == w[name].init, name
        assert str(g[name].dtype) == f"torch.{np.dtype(w[name].dtype).name}", name


# -- expert parallelism over gloo ranks ------------------------------------------------


@pytest.fixture(scope="module")
def ep_ref_proc(tmp_path_factory):
    """The reference's run, started at once so that it overlaps the ranks."""
    path = tmp_path_factory.mktemp("moe_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH="src",
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_moe_ref.py"),
                             str(path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ep_ref(ep_ref_proc):
    proc, path = ep_ref_proc
    log, _ = proc.communicate(timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, log
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ep_port(ep_ref_proc, tmp_path_factory):
    """Every rank's results: 2 ranks on (1, 2), 4 ranks on (1, 4) then
    (2, 2)."""
    params, x = R.inputs()
    out = {}
    for world, shapes in ((2, [(1, 2)]), (4, [(1, 4), (2, 2)])):
        tmp = tmp_path_factory.mktemp(f"moe_ep{world}")
        ranks = spawn_mod.spawn(torch_moe_ranks.run_rank, world, str(tmp / "rendezvous"),
                                "gloo", args=(shapes, params, x, R.CFG, R.MOE),
                                timeout_s=SPAWN_TIMEOUT_S)
        for shape in shapes:
            out[shape] = [r[shape] for r in ranks]
    return out


@pytest.mark.parametrize("shape", R.MESHES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_expert_parallel_forward_matches_reference(shape, ep_port, ep_ref):
    """Each rank holds its slice of the experts; the data shards' outputs,
    put back in batch order, equal the reference's ``moe_forward_ep`` on
    the same mesh, and each rank's equal the port's one-rank forward of
    its shard (within 1e-5: partial sums added in another order).  aux:
    each rank's equals its shard's one-rank aux; the reference returns
    data shard 0's."""
    ranks = ep_port[shape]
    n_data, n_model = shape
    per = R.MOE["num_experts"] // n_model
    y = np.zeros((R.B, R.S, R.D), np.float32)
    for r in ranks:
        d, m = r["coord"]
        assert r["experts"] == (m * per, (m + 1) * per)
        assert r["held"] == (per, R.D, R.MOE["d_ff"])
        y[r["lo"]:r["lo"] + R.B // n_data] = r["y"]
        np.testing.assert_allclose(r["y"], r["y1"], **EP_TOL)
        assert abs(r["aux"] - r["aux1"]) <= ROUTE_TOL
        if d == 0:
            assert abs(r["aux"] - float(ep_ref[f"{shape}/aux"])) <= ROUTE_TOL
    for r in ranks:     # every model rank of a data shard holds the same output
        np.testing.assert_array_equal(r["y"], y[r["lo"]:r["lo"] + R.B // n_data])
    np.testing.assert_allclose(y, ep_ref[f"{shape}/y"], **EP_TOL)
    # the inputs drop slots at capacity factor 1: the test reaches the spill
    if n_data == 1:
        np.testing.assert_allclose(y, ep_ref["single/y"], **EP_TOL)


def test_expert_rows_and_shard_follow_the_model_axis():
    """Every expert where the model axis is 1, absent or does not divide
    the experts (``moe_forward`` then does not take the expert-parallel
    path); the rank's slice where it does."""

    class _Mesh:
        def __init__(self, shape, coord):
            self.shape, self._coord = shape, coord

        def coord(self, axis):
            return self._coord[axis]

    assert M.expert_rows(8, None) == (0, 8)
    assert M.expert_rows(8, _Mesh({"data": 4, "model": 1}, {"model": 0})) == (0, 8)
    assert M.expert_rows(6, _Mesh({"data": 1, "model": 4}, {"model": 3})) == (0, 6)
    assert M.expert_rows(8, _Mesh({"data": 1, "model": 4}, {"model": 3})) == (6, 8)
    params, _ = R.inputs()
    shard = moe_shard_from_numpy(params, _Mesh({"data": 1, "model": 2}, {"model": 1}))
    for name in ("wi_gate", "wi_up", "wo"):
        assert np.array_equal(shard[name].numpy(), params[name][4:])
    assert np.array_equal(shard["router"].numpy(), params["router"])
    assert np.array_equal(shard["shared"]["wo"].numpy(), params["shared"]["wo"])
