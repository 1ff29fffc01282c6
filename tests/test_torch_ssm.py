"""The port's SSM serving slice (Mamba-2, ``mamba2-smoke``) against the
reference package.

The plain ``ssd_chunk_forward`` (the sequential recurrence) against the
Pallas kernel in interpret mode and the reference's oracle; the chunked
``ssd_chunked`` (y and final state), the convolutions, the mixer, the
prefill with state and the decode step against ``repro.models.ssm``;
``SSMLM`` prefill and decode, the serve CLI and the ``BatchingServer``
against the reference's, with the reference's weights carried across by
``repro_torch.convert``.  Inputs are made with numpy from a seed.  Each
test states its tolerance: float32 differs only by the order of sums;
bfloat16 also by where the two frameworks round.  The CUDA kernel has no
CPU mode: its tests are in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving.server import BatchingServer as JServer  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import ServerConfig as JServerConfig  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as kssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import SSMLM, build_model, hybrid, ssm  # noqa: E402
from repro_torch.serving import BatchingServer, Request, ServerConfig  # noqa: E402

ARCH = "mamba2-2.7b"
SMOKE = configs.get_smoke_config(ARCH)
J_SMOKE = jconfigs.get_smoke_config(ARCH)
F32 = dataclasses.replace(SMOKE, param_dtype=torch.float32, compute_dtype=torch.float32)
J_F32 = dataclasses.replace(J_SMOKE, param_dtype=jnp.float32, compute_dtype=jnp.float32)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# the reference's own sweep (tests/test_kernels.py) holds its Pallas SSD
# kernel to its sequential oracle within atol 5e-4, rtol 1e-3 (float32)
SWEEP_ATOL, SWEEP_RTOL = 5e-4, 1e-3


def _pair(a: np.ndarray, dtype: str):
    """One float32 numpy array as (torch, jax) arrays of ``dtype``; both
    round float32 to bfloat16 to nearest even, so the two start equal."""
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a, jd)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _rms_close(got, want, tol):
    """max |got - want| within ``tol`` of want's rms."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    rms = float(np.sqrt(np.mean(np.square(want))))
    assert np.abs(got - want).max() <= tol * rms, (np.abs(got - want).max(), rms)


def _ssd_inputs(seed, b, s, h, p, g, n):
    """SSD operands the way the mixer makes them: dt post-softplus, A
    negative (the reference's test_ssm.py scales)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, a, bm, cm


_JIT = jax.jit


def _strict_jit(fn):
    """``jax.jit`` compiled with XLA's excess precision off, so bf16
    intermediates are rounded to bf16 where the program says so, as the
    port (eager PyTorch) rounds them.  With it on, XLA keeps some fused
    bf16 intermediates in float32: at the smoke weights (dt reaches ~24)
    that moves the reference's own bf16 SSM state by ~40% of its rms
    between its jitted and op-by-op runs."""
    jitted, compiled = _JIT(fn), {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(a), np.result_type(a)) for a in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                {"xla_allow_excess_precision": False})
        return compiled[key](*args)

    return call


# -- configs ------------------------------------------------------------------------


def test_mamba2_constants_match_reference():
    """CONFIG and SMOKE equal the reference's field by field (dtypes by
    name), the SSM sub-config too."""
    for getter in ("get_config", "get_smoke_config"):
        got = getattr(configs, getter)(ARCH)
        want = getattr(jconfigs, getter)(ARCH)
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names
        for name in names:
            if name.endswith("_dtype"):
                assert str(getattr(got, name)) == f"torch.{np.dtype(getattr(want, name)).name}"
            elif name == "ssm":
                assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
            else:
                assert getattr(got, name) == getattr(want, name), name
        assert (got.attention_free, got.sub_quadratic) == (want.attention_free,
                                                          want.sub_quadratic)
        assert got.ssm.d_inner(got.d_model) == want.ssm.d_inner(want.d_model)
        assert got.ssm.n_heads(got.d_model) == want.ssm.n_heads(want.d_model)
    full = configs.get_config(ARCH)
    assert (full.num_layers, full.d_model, full.ssm.n_heads(full.d_model),
            full.ssm.d_state, full.vocab_size) == (64, 2560, 80, 128, 50280)
    assert ARCH in configs.ARCH_IDS and ARCH in serve.LM_ARCHS


# -- the SSD scan ---------------------------------------------------------------------


@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (2, 64, 32, 16, 16), (4, 128, 64, 32, 32), (1, 96, 64, 64, 32),
])
def test_plain_ssd_matches_pallas_and_ref(bh, s, p, n, chunk):
    """The reference's sweep shapes: the port's plain version (the TPU
    kernel's layout) against the Pallas kernel in interpret mode and the
    reference's oracle within the sweep's tolerance; its final state
    against the reference model's chunked scan on the same rows, within
    1e-4 of the state's rms (float32 sums in another order)."""
    # rows as the heads of one batch row, each its own group: the model's
    # layout of the same function
    x, dt, a, bm, cm = _ssd_inputs(bh + s, 1, s, bh, p, bh, n)
    rows = [np.ascontiguousarray(t[0].swapaxes(0, 1)) for t in (x, dt, bm, cm)]
    args = [rows[0], rows[1], a, rows[2], rows[3]]
    y, state = ref.ssd_chunk_forward(*(torch.from_numpy(t) for t in args))
    assert y.shape == (bh, s, p) and state.shape == (bh, n, p) and state.dtype == torch.float32
    jargs = [jnp.asarray(t) for t in args]
    for want in (jops.ssd_chunk_forward(*jargs, chunk=chunk, use_pallas=True),
                 jref.ssd_chunk_forward(*jargs)):
        np.testing.assert_allclose(_np(y), _np(want), atol=SWEEP_ATOL, rtol=SWEEP_RTOL)
    _, jstate = jssm.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)), chunk=chunk)
    _rms_close(state, jnp.swapaxes(jstate[0], -1, -2), 1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("groups,s,chunk", [(1, 64, 16), (2, 64, 16), (2, 40, 16),
                                            (1, 48, 64)])
def test_ssd_chunked_matches_reference(groups, s, chunk, dtype):
    """The port's chunked scan (the CPU form of ``ssd_chunked``) against
    ``repro.models.ssm.ssd_chunked``: y and the final state, S a multiple
    of the chunk and ragged (40 = 2.5 chunks of 16: both fall back to one
    chunk of S) and shorter than it.  float32 within 1e-4 of the rms (sums
    in another order, and the port's cumsum is float64); bfloat16, where
    both round C.B^T, m and y_intra to bf16, within 2e-2 of y's rms (one
    bf16 ulp, 2^-8 of a value up to 4x the rms, where a rounding flips)
    and 1e-4 of the state's (computed in float32 from the same bf16
    inputs)."""
    x, dt, a, bm, cm = _ssd_inputs(s + groups, 2, s, 4, 8, groups, 16)
    (tx, jx), (tb, jb), (tc, jc) = (_pair(t, dtype) for t in (x, bm, cm))
    y, state = ssm.ssd_chunked(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc, chunk)
    jy, jstate = jssm.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, chunk=chunk)
    assert y.dtype == DTYPES[dtype][0] and state.dtype == torch.float32
    _rms_close(y, jy, 1e-4 if dtype == "f32" else 2e-2)
    _rms_close(state, jstate, 1e-4)


def test_ssd_with_initial_state_and_plain_model_layout_match_reference():
    """An initial state carries through the chunked form; the plain version
    in the model's layout (``ops.ssd_chunk_forward`` on the CPU, the
    sequential recurrence, groups broadcast over heads) gives the
    reference model's y and state within the sweep's tolerance."""
    x, dt, a, bm, cm = _ssd_inputs(9, 2, 32, 4, 8, 2, 16)
    init = np.random.default_rng(10).standard_normal((2, 4, 8, 16)).astype(np.float32)
    targs = [torch.from_numpy(t) for t in (x, dt, a, bm, cm)]
    jargs = [jnp.asarray(t) for t in (x, dt, a, bm, cm)]
    jy, jstate = jssm.ssd_chunked(*jargs, chunk=8, initial_state=jnp.asarray(init))
    y, state = ssm.ssd_chunked(*targs, 8, initial_state=torch.from_numpy(init))
    _rms_close(y, jy, 1e-4)
    _rms_close(state, jstate, 1e-4)
    y, state = ops.ssd_chunk_forward(*targs, chunk=8, initial_state=torch.from_numpy(init))
    np.testing.assert_allclose(_np(y), _np(jy), atol=SWEEP_ATOL, rtol=SWEEP_RTOL)
    np.testing.assert_allclose(_np(state), _np(jstate), atol=SWEEP_ATOL, rtol=SWEEP_RTOL)


def _scan64(x, dt, a, b_, c_):
    """The sequential recurrence in float64: y (B, S, H, P), state (B, H, P, N)."""
    bsz, s, h, p = x.shape
    hg = h // b_.shape[2]
    x, dt, a, b_, c_ = (t.double() for t in (x, dt, a, b_, c_))
    b_, c_ = b_.repeat_interleave(hg, 2), c_.repeat_interleave(hg, 2)
    state = torch.zeros((bsz, h, p, b_.shape[3]), dtype=torch.float64)
    ys = []
    for t in range(s):
        state = state * torch.exp(dt[:, t] * a)[:, :, None, None] + \
            (x[:, t] * dt[:, t, :, None])[..., None] * b_[:, t, :, None, :]
        ys.append((state @ c_[:, t, :, :, None])[..., 0])
    return torch.stack(ys, 1), state


def test_ssd_float64_cumsum_at_large_dt(capsys):
    """The port's one deliberate difference from the reference: cs, the
    cumsum of dt*A, runs in float64.  Here dt = softplus(50 z) reaches
    ~190 and |cs| ~7,400 over one chunk of 256, as at the random
    full-width ``mamba2-2.7b`` (its "scaled" fan-in puts dt*A near -150 a
    position), so a float32 cs keeps |cs| * 2^-24 ~ 4e-4 absolute and
    exp(cs_i - cs_j) of nearby positions loses that much.  Against the
    float64 sequential recurrence: the port's chunked form and the float32
    sequential recurrence (the kernel's plain version) within 1e-5 of the
    rms (y and the final state; measured ~2e-6); the reference's chunked
    form (float32 cs) sits ~100x further away (measured 8.3e-4 in y and
    5.5e-4 in the state), and the port holds to the reference within 2e-3
    of the rms, the measured gap with room to spare.  Printed: each form's
    largest |diff| over the rms."""
    rng = np.random.default_rng(0)
    b, s, h, p, g, n, chunk = 2, 256, 4, 8, 1, 16, 256
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.logaddexp(50 * rng.standard_normal((b, s, h)), 0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    assert dt.max() > 150 and (dt * a).sum(1).min() < -5000
    targs = [torch.from_numpy(t) for t in (x, dt, a, bm, cm)]
    y64, state64 = _scan64(*targs)
    jy, jstate = jssm.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)), chunk=chunk)
    forms = {"port": ssm.ssd_chunked(*targs, chunk), "sequential": ref.ssd_scan(*targs),
             "reference": (torch.tensor(_np(jy)), torch.tensor(_np(jstate)))}

    def over_rms(got, want):
        return float((got.double() - want).abs().max() / want.square().mean().sqrt())

    gaps = {name: (over_rms(y, y64), over_rms(state, state64))
            for name, (y, state) in forms.items()}
    with capsys.disabled():
        print(f"\n[SSD, dt to {dt.max():.0f}] max |diff| over rms from the float64 "
              f"recurrence (y, state): {gaps}")
    for name in ("port", "sequential"):
        assert max(gaps[name]) <= 1e-5, (name, gaps[name])
    assert gaps["reference"][0] > 100 * gaps["port"][0]
    _rms_close(forms["port"][0], jy, 2e-3)
    _rms_close(forms["port"][1], jstate, 2e-3)


# -- the mixer ------------------------------------------------------------------------


def _mixer_params(cfg, dtype, seed=0):
    """One layer's mixer weights with the reference's spec shapes, scaled so
    activations stay O(1), and A_log, dt_bias away from their zero init."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in ssm.ssm_specs(cfg).items():
        a = rng.standard_normal(spec.shape).astype(np.float32) / np.sqrt(spec.shape[0])
        if name in ("A_log", "dt_bias"):
            a = 0.3 * rng.standard_normal(spec.shape).astype(np.float32)
        if name in ("D", "norm"):
            a = 1 + 0.1 * rng.standard_normal(spec.shape).astype(np.float32)
        t = torch.from_numpy(a).to(spec.dtype if spec.dtype == torch.float32 else
                                   DTYPES[dtype][0])
        out[name] = (t, jnp.asarray(a, jnp.float32 if spec.dtype == torch.float32
                                    else DTYPES[dtype][1]))
    return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}


# the reference jitted without excess precision (``_strict_jit``).  float32
# within 1e-4 of the rms (sums in another order); bfloat16 within 2e-2:
# every product is rounded to bf16 and a one-ulp flip of an activation
# moves what follows it
MIXER_TOL = {"f32": 1e-4, "bf16": 2e-2}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_convs_mixer_and_prefill_with_state_match_reference(dtype):
    cfg, jcfg = (F32, J_F32) if dtype == "f32" else (SMOKE, J_SMOKE)
    tol = MIXER_TOL[dtype]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    tx, jx = _pair(x, dtype)
    w = (rng.standard_normal((4, cfg.d_model)) * 0.5).astype(np.float32)
    tw, jw = _pair(w, dtype)
    _rms_close(ssm._causal_conv(tx, tw), jssm._causal_conv(jx, jw), tol)
    state = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    ts, js = _pair(state, dtype)
    got, got_state = ssm._conv_step(tx[:, 0], ts, tw)
    want, want_state = jssm._conv_step(jx[:, 0], js, jw)
    _rms_close(got, want, tol)
    _rms_close(got_state, want_state, 0)

    tp, jp = _mixer_params(cfg, dtype)
    _rms_close(ssm.ssm_forward(tp, tx, cfg),
               _strict_jit(lambda p, x: jssm.ssm_forward(p, x, jcfg))(jp, jx), tol)
    got = hybrid._ssm_prefill_with_state(tp, tx, cfg)
    want = _strict_jit(lambda p, x: jhybrid._ssm_prefill_with_state(p, x, jcfg))(jp, jx)
    for name, g, w_ in zip(("out", "state", "conv_x", "conv_B", "conv_C"), got, want):
        assert tuple(g.shape) == w_.shape, name
        _rms_close(g, w_, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_decode_step_matches_reference(dtype):
    """Three decode steps from a non-zero cache; the cache they return
    too (the reference jitted without excess precision)."""
    cfg, jcfg = (F32, J_F32) if dtype == "f32" else (SMOKE, J_SMOKE)
    tol = MIXER_TOL[dtype]
    rng = np.random.default_rng(5)
    tp, jp = _mixer_params(cfg, dtype, seed=1)
    cache = {name: rng.standard_normal(t.shape).astype(np.float32)
             for name, t in ssm.ssm_init_cache(cfg, 2, dtype=cfg.compute_dtype).items()}
    tc = {k: torch.from_numpy(v) if k == "state" else _pair(v, dtype)[0]
          for k, v in cache.items()}
    jc = {k: jnp.asarray(v) if k == "state" else _pair(v, dtype)[1] for k, v in cache.items()}
    jstep = _strict_jit(lambda p, x, c: jssm.ssm_decode_step(p, x, c, jcfg))
    for step in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        tx, jx = _pair(x, dtype)
        out, tc = ssm.ssm_decode_step(tp, tx, tc, cfg)
        jout, jc = jstep(jp, jx, jc)
        _rms_close(out, jout, tol)
        for name in cache:
            assert tc[name].dtype == (torch.float32 if name == "state" else cfg.compute_dtype)
            _rms_close(tc[name], jc[name], tol)


# -- the model ------------------------------------------------------------------------


def _models(cfg, jcfg, seed=0):
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams)))
    return model, jmodel, jparams


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits and cache (state and conv tails) over 2 chunks, then
    4 greedy decode steps' logits and the cache, greedy tokens equal, the
    reference jitted without excess precision (``_strict_jit``).  float32
    within 1e-3 of each tensor's rms: sums in another order, and the two
    cumsums differ by float32 ulps of |cs| (in the hundreds here: dt
    reaches ~24), which the decays exp(cs_i - cs_j) carry into the state.
    bfloat16 within 1e-2 of the rms (the state is float32 and sums in
    another order; a bf16 tensor may flip an ulp, 2^-8 of a value)."""
    cfg, jcfg = (F32, J_F32) if dtype == "f32" else (SMOKE, J_SMOKE)
    tol = 1e-3 if dtype == "f32" else 1e-2
    model, jmodel, jparams = _models(cfg, jcfg)
    assert isinstance(model, SSMLM)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    jprefill, jdecode = _strict_jit(jmodel.prefill), _strict_jit(jmodel.decode_step)
    logits, cache = model.prefill({"tokens": torch.from_numpy(tokens)})
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(tokens)})
    assert logits.shape == jlogits.shape == (2, 1, cfg.vocab_size)
    assert logits.dtype == cfg.compute_dtype
    _rms_close(logits, jlogits, tol)
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        _rms_close(cache[name], jcache[name], tol)

    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    for pos in range(4):
        assert tok.numpy().tolist() == np.asarray(jtok).tolist()
        lg, cache = model.decode_step({"token": tok, "pos": pos, "cache": cache})
        jlg, jcache = jdecode(jparams, {"token": jtok, "pos": jnp.asarray(pos, jnp.int32),
                                        "cache": jcache})
        _rms_close(lg, jlg, tol)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        jtok = jnp.argmax(jlg, axis=-1).astype(jnp.int32)
    for name in cache:
        _rms_close(cache[name], jcache[name], tol)


def test_decode_continues_prefill_state():
    """The port of the reference's test_ssm.py check: prefill over s tokens
    then one decode step gives the logits of a prefill over s+1 tokens.
    bf16 within the reference test's own tolerance (atol 0.08, rtol 0.05);
    float32 within 1e-4 of the rms (the chunked and the one-step forms
    differ only by rounding)."""
    for cfg, tol in ((SMOKE, None), (F32, 1e-4)):
        model = build_model(cfg, device="cpu").init(0)
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (2, 17)).astype(np.int32))
        full, _ = model.prefill({"tokens": toks})
        _, cache = model.prefill({"tokens": toks[:, :-1]})
        step, _ = model.decode_step({"token": toks[:, -1:], "pos": 16, "cache": cache})
        if tol is None:
            np.testing.assert_allclose(_np(step[:, 0]), _np(full[:, 0]), atol=0.08, rtol=0.05)
        else:
            _rms_close(step, full, tol)


def test_convert_round_trips_and_init_is_seeded():
    """The reference's SSM tree crosses both ways bit for bit (bf16 and the
    float32 A_log, D, dt_bias, norm); a model's init is a function of its
    seed with the reference's initializers and its stacked fan-in."""
    model, jmodel, jparams = _models(SMOKE, J_SMOKE)
    back = convert.lm_params_to_numpy(model)
    jflat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    bflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in jflat] == [p for p, _ in bflat]
    for (path, a), (_, b) in zip(jflat, bflat):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    shapes = {k: (tuple(s), d) for k, (s, d) in model.abstract_cache(2, 8).items()}
    for name, sd in jmodel.abstract_cache(2, 8).items():
        assert shapes[name][0] == sd.shape, name
        assert str(shapes[name][1]) == f"torch.{np.dtype(sd.dtype).name}", name
        arr = np.random.default_rng(1).standard_normal(sd.shape).astype(sd.dtype)
        got = convert.lm_cache_from_numpy({name: arr})[name]
        assert convert._array(got).tobytes() == np.asarray(arr).tobytes(), name

    a = build_model(SMOKE, device="cpu").init(3)
    b = build_model(SMOKE, device="cpu").init(3)
    c = build_model(SMOKE, device="cpu").init(4)
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith(("norm", "ln1", "ln_f", ".D")):
            assert torch.equal(pa, torch.ones_like(pa)), name
        elif name.endswith(("A_log", "dt_bias")):
            assert torch.equal(pa, torch.zeros_like(pa)), name
        else:
            assert not torch.equal(pa, pc), name
    # "scaled" layer leaves: std 1/sqrt(number of layers), the stacked fan-in
    wx = torch.stack([layer.mixer.wx.float() for layer in a.layers])
    assert abs(wx.std().item() - 1 / np.sqrt(SMOKE.num_layers)) < 0.02


# -- serving --------------------------------------------------------------------------


def test_serve_main_smoke_cpu(capsys):
    rc = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "8", "--decode-steps", "4", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "arch=mamba2-smoke prefill_s=" in out and "decode_tok_per_s=" in out
    assert "finite logits: True" in out
    assert len(out.split("sampled tokens[0]: [")[1].split("]")[0].split(",")) == 5


def test_serve_gives_the_reference_tokens(monkeypatch, capsys):
    """``repro.launch.serve --arch mamba2-2.7b --smoke`` (bf16, the CLI's
    defaults, its jits compiled without XLA's excess precision) and the
    port's ``serve`` on the reference's seed-0 weights (through
    ``convert``) and the same prompt sample the same 16 tokens."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke"])
    monkeypatch.setattr(jax, "jit", _strict_jit)
    assert jserve.main() == 0
    monkeypatch.undo()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("sampled tokens[0]:")][0]
    want = [int(t) for t in line.split(": [")[1].split("]")[0].split(",")]
    jparams = j_build_model(J_SMOKE).init(jax.random.PRNGKey(0))
    model = build_model(SMOKE, device="cpu")
    model.load_state_dict(convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams)))
    out = serve.serve(model)
    assert out["tokens"][0, :16].tolist() == want
    assert torch.isfinite(out["logits"].float()).all()


def test_port_against_the_default_jit_reference(monkeypatch, capsys):
    """The reference as it normally runs (``jax.jit`` with XLA's excess
    precision on), against the port at the reference's seed-0 weights in
    bf16: a (2, 64) prefill's logits within 0.1 of their rms (the bf16
    card-vs-CPU bound of ``chip_smoke.py``) and the serve CLI's first
    sampled token equal.  Printed: the logits' and the prefill cache's
    largest |diff| over the rms, and how many of the CLI's 16 sampled
    tokens agree before the first that differs."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke"])
    assert jserve.main() == 0
    monkeypatch.undo()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("sampled tokens[0]:")][0]
    want = [int(t) for t in line.split(": [")[1].split("]")[0].split(",")]
    model, jmodel, jparams = _models(SMOKE, J_SMOKE)
    got = serve.serve(model)["tokens"][0, :16].tolist()
    agree = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), len(want))
    tokens = np.random.default_rng(11).integers(0, SMOKE.vocab_size, (2, 64)).astype(np.int32)
    logits, cache = model.prefill({"tokens": torch.from_numpy(tokens)})
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})

    def over_rms(g, w):
        g, w = _np(g), _np(w)
        return float(np.abs(g - w).max() / np.sqrt(np.mean(np.square(w))))

    gaps = {"logits": over_rms(logits, jlogits),
            **{name: over_rms(cache[name], jcache[name]) for name in sorted(cache)}}
    with capsys.disabled():
        print(f"\n[default-jit reference, bf16 mamba2-smoke] max |diff| over rms {gaps}; "
              f"serve CLI tokens equal for {agree} of {len(want)}")
    assert gaps["logits"] <= 0.1 and agree >= 1


def test_batching_server_matches_reference():
    """Two requests sharing the slots give the reference's outputs token
    for token (float32, the reference's seed-0 weights): the state
    overwrite of the slots is the reference's, kept."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, F32.vocab_size, 8).astype(np.int32) for _ in range(2)]
    jserver = JServer(J_F32, JServerConfig(slots=2, cache_len=32), seed=0)
    server = BatchingServer(F32, ServerConfig(slots=2, cache_len=32), device="cpu",
                            params=convert.lm_params_from_numpy(
                                jax.tree.map(np.asarray, jserver.params)))
    assert isinstance(server.model, SSMLM)
    outs = []
    for srv, req in ((jserver, JRequest), (server, Request)):
        for i, p in enumerate(prompts):
            srv.submit(req(rid=i, prompt=p, max_new_tokens=6))
        outs.append({r.rid: list(r.output) for r in srv.run()})
    assert outs[1] == outs[0]
    assert all(len(o) == 6 for o in outs[1].values())


# -- the device contract --------------------------------------------------------------


def test_ssm_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_model(SMOKE)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        BatchingServer(SMOKE, ServerConfig(slots=1, cache_len=8))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        serve.main(["--arch", ARCH, "--smoke"])


class _Elsewhere:
    """A stand-in for a tensor on a device that is neither CPU, CUDA nor
    ``meta`` (the dispatchers read only its shape and device)."""

    def __init__(self, t):
        self.shape, self.dtype = t.shape, t.dtype
        self.device = torch.device("xpu")
        self.requires_grad = False


def test_ssd_wrapper_refuses_cpu_and_dispatch_other_devices():
    """No silent fallback: the kernel's wrapper takes CUDA tensors only,
    and the dispatcher and the model's scan refuse a device that is
    neither CPU, CUDA nor ``meta``; on ``meta`` both give empty results."""
    x = torch.zeros((1, 8, 2, 4))
    dt = torch.zeros((1, 8, 2))
    a = torch.zeros(2)
    bm = torch.zeros((1, 8, 1, 4))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kssd.ssd_chunk_forward(x, dt, a, bm, bm)
    meta = [t.to("meta") for t in (x, dt, a, bm, bm)]
    other = [_Elsewhere(t) for t in meta]
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd_chunk_forward(*other)
    with pytest.raises(ValueError, match="no SSD scan for device"):
        ssm.ssd_chunked(*other, chunk=4)
    for y, state in (ops.ssd_chunk_forward(*meta), ssm.ssd_chunked(*meta, chunk=4)):
        assert (y.device.type, y.shape, state.shape) == ("meta", x.shape, (1, 2, 4, 4))
