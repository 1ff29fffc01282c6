"""The port's DiLoCo outer step (``repro_torch.distributed.diloco``)
against the reference's ``repro.distributed.diloco``.

``outer_init``, ``outer_step`` with bf16 compression on and off, over
several outer rounds of three pods, and ``comm_savings``, on random
nested trees of float32 and bf16 leaves drawn with numpy.  Every
operation is one IEEE float32 operation or a bf16 rounding (round to
nearest even) in both packages, so the results are held bit for bit;
``mean_over_pods`` is each package's mean of the pods' deltas, summed in
float32 in pod order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.distributed import diloco as J  # noqa: E402
from repro_torch.distributed import diloco as D  # noqa: E402

PODS = 3
ROUNDS = 3


def _tree(rng):
    return {"w": rng.standard_normal((8, 5)).astype(np.float32),
            "blk": {"b": rng.standard_normal((7,)).astype(np.float32),
                    "h": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16)}}


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _torch(tree):
    return _map(lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a.copy()), tree)


def _np(tree):
    return _map(lambda t: np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                                     else np.asarray(t).astype(np.float32)), tree)


def _run_reference(cfg, params0, drifts):
    """``ROUNDS`` outer steps of pod 0, the pods' params being the anchor
    plus each pod's drift; returns pod 0's params and state each round."""
    params = jax.tree.map(jnp.asarray, params0)
    state = J.outer_init(params)
    out = []
    for r in range(ROUNDS):
        pods = [jax.tree.map(lambda a, d, p: (a + d).astype(p.dtype), state["anchor"],
                             jax.tree.map(jnp.asarray, drifts[r][i]), params)
                for i in range(PODS)]

        def mean(delta, pods=pods, anchor=state["anchor"]):
            others = [jax.tree.map(lambda a, p, d: (a - p.astype(jnp.float32)).astype(d.dtype),
                                   anchor, q, delta) for q in pods]
            total = jax.tree.map(lambda *xs: sum(x.astype(jnp.float32) for x in xs), *others)
            return jax.tree.map(lambda t, d: (t / PODS).astype(d.dtype), total, delta)

        params, state = J.outer_step(pods[0], state, cfg, mean)
        out.append((_np(params), _np(state)))
    return out


def _run_port(cfg, params0, drifts):
    params = _torch(params0)
    state = D.outer_init(params)
    out = []
    for r in range(ROUNDS):
        pods = [_map(lambda a, d, p: (a + torch.from_numpy(d.astype(np.float32))).to(p.dtype),
                     state["anchor"], drifts[r][i], params) for i in range(PODS)]

        def mean(delta, pods=pods, anchor=state["anchor"]):
            others = [_map(lambda a, p, d: (a - p.float()).to(d.dtype), anchor, q, delta)
                      for q in pods]
            total = _map(lambda *xs: sum(x.float() for x in xs), *others)
            return _map(lambda t, d: (t / PODS).to(d.dtype), total, delta)

        params, state = D.outer_step(pods[0], state, cfg, mean)
        out.append((_np(params), _np(state)))
    return out


@pytest.mark.parametrize("compress", [True, False], ids=["bf16", "f32"])
def test_outer_steps_match_reference(compress):
    rng = np.random.default_rng(3)
    cfg = dataclasses.replace(J.DiLoCoConfig(inner_steps=4), compress_bf16=compress)
    pcfg = D.DiLoCoConfig(inner_steps=4, compress_bf16=compress)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    params0 = _tree(rng)
    drifts = [[_map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                    params0) for _ in range(PODS)] for _ in range(ROUNDS)]
    ref, port = _run_reference(cfg, params0, drifts), _run_port(pcfg, params0, drifts)
    for (rp, rs), (pp, ps) in zip(ref, port):
        for want, got in ((rp, pp), (rs, ps)):
            _map(lambda w, g: np.testing.assert_array_equal(g, w), want, got)


def test_outer_init_matches_reference():
    params0 = _tree(np.random.default_rng(5))
    want = _np(J.outer_init(jax.tree.map(jnp.asarray, params0)))
    got = D.outer_init(_torch(params0))
    assert all(t.dtype == torch.float32 for t in (got["anchor"]["w"], got["momentum"]["blk"]["h"]))
    _map(lambda w, g: np.testing.assert_array_equal(g, w), want, _np(got))


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("inner", [1, 4, 32, 100])
def test_comm_savings_matches_reference(inner, compress):
    cfg = J.DiLoCoConfig(inner_steps=inner, compress_bf16=compress)
    pcfg = D.DiLoCoConfig(inner_steps=inner, compress_bf16=compress)
    for nbytes in (100, 4_000_000_007):
        assert D.comm_savings(pcfg, nbytes) == J.comm_savings(cfg, nbytes)
