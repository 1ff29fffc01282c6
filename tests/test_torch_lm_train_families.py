"""The port's training slice for the SSM, hybrid and encoder-decoder
families against the reference: ``ssd_chunked``'s VJP (the chunked form
under autograd, each chunk checkpointed) against ``jax.vjp`` of the
reference's, ``SSMLM``, ``HybridLM`` and ``EncDecLM`` ``loss`` and every
gradient, ``EncDecLM.prefill`` unchanged by its ``_decoder_layer``, every
arch's ``input_specs`` and ``cache_logical_axes``, ``active_params`` and
``param_count(cfg)``.  The ``Trainer``, checkpoints and the CLI are in
``test_torch_lm_train_families_fit.py``.

Smoke widths; ``attn_chunk``, ``attn_k_chunk`` and ``logit_chunk`` 32,
so the attention and the cross-entropy loop over blocks and chunks, and
the SSD over chunks of 32.  The reference's weights come across with
``convert.lm_params_from_numpy``, tamed in both packages (``_tame``: a
MoE router scaled by ``ROUTER_SCALE``, the attentions' q and k
projections by ``QK_SCALE``).  float32 differs by the order of sums and
by the port's float64 cumsum in the SSD; bf16 is held against the
reference's float32 run, as far from it as the reference's own bf16 run
compiled without excess precision (``_strict_jit``), in relative norm,
each tolerance stated where it is set.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import param_count as j_param_count  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import attention, build_model, layers, ssm  # noqa: E402
from repro_torch.models.common import ModelConfig, param_count  # noqa: E402

from test_torch_lm_train import CHUNKS, DTYPES, ROUTER_SCALE, _grads, _rel  # noqa: E402
from test_torch_ssm import _ssd_inputs, _strict_jit  # noqa: E402

SEQ, BATCH = 64, 2            # two SSD chunks of the smoke's 32
ARCHS = {"ssm": "mamba2-2.7b", "hybrid": "jamba-1.5-large-398b",
         "encdec": "seamless-m4t-large-v2"}
# ssd_chunked's VJP: float32 within 1e-5 of each output's and gradient's
# norm (measured up to 2e-6: sums in another order, the port's float64
# cumsum); bf16 within 2e-2 (test_torch_ssm.MIXER_TOL's bound: a bf16
# rounding that differs moves what follows it)
SSD_VJP_TOL = {"f32": 1e-5, "bf16": 2e-2}
# the reference's init takes a stack's length (1 or 2) as the fan-in of
# every "scaled" leaf, so at smoke widths without qk_norm the attention
# scores reach ~60 and the softmax is one-hot: there each package's float32
# gradients sit up to 5e-3 from the port's float64 run (the reference's
# further than the port's), the two 9e-3 apart, and bf16 gradients are
# noise in both.  Both packages' wq and wk are scaled by QK_SCALE (the
# scores by 1/64), as both packages' routers by ROUTER_SCALE.
QK_SCALE = 0.125
# the models' loss (rtol) and every gradient (relative norm) against the
# reference's jax.value_and_grad.  float32: 1e-5 and 1e-3 (worst measured
# 2.7e-5 SSM, 2.2e-4 hybrid, 3.1e-6 encoder-decoder: sums in another
# order, the port's float64 cumsum).  bf16: the loss within 1e-3 of the
# reference's bf16 one compiled strictly (test_torch_lm_train's bound;
# measured up to 1.8e-4), and each gradient no farther from the reference's float32
# gradient than BF16_FACTOR times the reference's own bf16 one plus
# BF16_FLOOR (measured: both packages 2e-2 to 0.26 from it, the hybrid's
# SSM leaves the farthest, the port at most 1.3x the reference's distance);
# worst values print with -s
LOSS_RTOL = {"f32": 1e-5, "bf16": 1e-3}
F32_GRAD_TOL, BF16_FACTOR, BF16_FLOOR = 1e-3, 1.5, 2e-2
FAMILY_CASES = {"ssm": {}, "hybrid": {}, "hybrid_no_moe": {"moe_period": 0},
                "encdec": {}}


def _cfgs(case, dtype, **change):
    """The smoke config of ``case`` in both packages at ``CHUNKS``."""
    arch = ARCHS[case.split("_")[0]]
    td, jd = DTYPES[dtype]
    change = {**CHUNKS, **FAMILY_CASES.get(case, {}), **change}
    return (dataclasses.replace(configs.get_smoke_config(arch), param_dtype=td,
                                compute_dtype=td, **change),
            dataclasses.replace(jconfigs.get_smoke_config(arch), param_dtype=jd,
                                compute_dtype=jd, **change))


def _tame(tree):
    """A reference tree (nested dicts) with every MoE router times
    ``ROUTER_SCALE`` and every attention's ``wq`` and ``wk`` times
    ``QK_SCALE``, in place."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _tame(val)
            continue
        scale = {"router": ROUTER_SCALE, "wq": QK_SCALE, "wk": QK_SCALE}.get(key)
        if scale is not None:
            tree[key] = (val * scale).astype(val.dtype)


def _models(cfg, jcfg, seed=0):
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    _tame(jparams)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_numpy(jparams))
    return model, jmodel, jparams


def _batch(cfg, seed=0, seq=SEQ):
    """A training batch: ``seq`` tokens a row, or for the encoder-decoder
    ``seq`` frames and ``seq // 2`` decoder tokens."""
    rng = np.random.default_rng(seed)
    t = seq // 2 if cfg.encoder_layers else seq
    toks = rng.integers(0, cfg.vocab_size, (BATCH, t)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.encoder_layers:
        out["frames"] = rng.normal(0, 0.02, (BATCH, seq, cfg.d_model)).astype(np.float32)
    return out


# -- ssd_chunked under autograd -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [16, 24])       # 24 does not divide 64: one chunk
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_vjp_matches_reference(groups, chunk, with_state, dtype):
    """y, the final state and the gradients of x, dt, A, B, C (and of the
    initial state) against ``jax.vjp`` of the reference's
    ``ssd_chunked``, the cotangents of y and of the final state random,
    each within ``SSD_VJP_TOL`` in relative norm."""
    td, jd = DTYPES[dtype]
    b, s, h, p, n = BATCH, SEQ, 4, 8, 8
    arrays = list(_ssd_inputs(11, b, s, h, p, groups, n))
    rng = np.random.default_rng(12)
    if with_state:
        arrays.append(rng.standard_normal((b, h, p, n)).astype(np.float32))
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32)
    # x, B, C in the compute dtype; dt, A and the state float32, as the mixer holds them
    cast = [td, torch.float32, torch.float32, td, td, torch.float32]
    jcast = [jd, jnp.float32, jnp.float32, jd, jd, jnp.float32]
    targs = [torch.from_numpy(a).to(c).requires_grad_() for a, c in zip(arrays, cast)]
    y, state = ssm.ssd_chunked(*targs[:5], chunk, *targs[5:])
    got = torch.autograd.grad([y, state], targs,
                              [torch.from_numpy(dy).to(td), torch.from_numpy(dstate)])

    def ref(*args):
        *xs, gy, gs = args
        out, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a[:5], chunk, *a[5:]), *xs)
        return (*out, *vjp((gy, gs)))

    jargs = [jnp.asarray(a, c) for a, c in zip(arrays, jcast)]
    fn = _strict_jit(ref) if dtype == "bf16" else jax.jit(ref)
    want = fn(*jargs, jnp.asarray(dy, jd), jnp.asarray(dstate))
    names = ["y", "state", "dx", "ddt", "dA", "dB", "dC", "dstate0"]
    for name, g, w in zip(names, (y, state, *got), want):
        assert tuple(g.shape) == w.shape and torch.isfinite(g).all(), name
        assert _rel(g, w) < SSD_VJP_TOL[dtype], (name, _rel(g, w))


def _ssd_grads(chunk=16):
    arrays = _ssd_inputs(13, BATCH, SEQ, 4, 8, 2, 8)
    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, state = ssm.ssd_chunked(*targs, chunk)
    return targs, y, state


def test_ssd_chunk_remat_gives_bit_equal_gradients(monkeypatch):
    """Each chunk inside ``checkpoint`` (once a chunk under autograd)
    against the same scan with the checkpoint a plain call: y, the state
    and every gradient bit-equal."""
    calls = []
    real = ssm.checkpoint

    def counting(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    out = []
    for wrap in (counting, lambda fn, *args, **kwargs: fn(*args)):
        monkeypatch.setattr(ssm, "checkpoint", wrap)
        targs, y, state = _ssd_grads()
        out.append((y, state, torch.autograd.grad((y.sum() + state.square().sum()), targs)))
    assert len(calls) == SEQ // 16
    (y0, s0, g0), (y1, s1, g1) = out
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_ssd_chunked_keeps_no_chunk_scores():
    """Under autograd the graph holds each chunk's inputs, not its
    (B, Q, Q, H) decay and score tensors; without grad there is no graph."""
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        targs, y, state = _ssd_grads()
    assert saved and all(s[1:3] != (16, 16) for s in saved), saved
    assert y.grad_fn is not None
    with torch.no_grad():
        y, state = ssm.ssd_chunked(*(t.detach() for t in targs), 16)
    assert y.grad_fn is None and state.grad_fn is None


def test_ssd_chunked_route_needs_a_grad_operand():
    """The training route is taken when grad is on and an operand needs a
    gradient; serving operands run the plain forward, no graph."""
    arrays = [torch.from_numpy(a) for a in _ssd_inputs(14, 1, 32, 2, 4, 1, 4)]
    y, _ = ssm.ssd_chunked(*arrays, 16)
    assert y.grad_fn is None
    with torch.no_grad():
        want, _ = ssm.ssd_chunked(*arrays, 16)
    a = arrays[2].clone().requires_grad_()
    y, _ = ssm.ssd_chunked(*arrays[:2], a, *arrays[3:], 16)
    assert y.grad_fn is not None and torch.equal(y.detach(), want)


# -- the families' loss ---------------------------------------------------------------


def _ref_loss_and_grads(jmodel, jparams, batch, strict=False):
    fn = jax.value_and_grad(jmodel.loss)
    fn = _strict_jit(fn) if strict else jax.jit(fn)
    jloss, jgrads = fn(jax.tree.map(jnp.asarray, jparams),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    return float(jloss), convert.lm_params_from_numpy(jax.tree.map(np.asarray, jgrads))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_family_loss_and_grads_match_reference(case, dtype):
    """``loss`` and every gradient of ``SSMLM``, ``HybridLM`` (with its MoE
    sublayers and with ``moe_period`` 0) and ``EncDecLM`` against the
    reference's ``jax.value_and_grad(loss)``, remat on as the full configs
    train: float32 directly; bf16 the loss directly and each gradient
    against the reference's float32 one, beside the reference's own bf16
    gradient (``BF16_FACTOR``, ``BF16_FLOOR``).  Every gradient in the
    parameter's dtype and finite."""
    cfg, jcfg = _cfgs(case, dtype, remat=True)
    model, jmodel, jparams = _models(cfg, jcfg)
    batch = _batch(cfg)
    loss, grads = _grads(model, batch)
    jloss, want = _ref_loss_and_grads(jmodel, jparams, batch, strict=dtype == "bf16")
    assert sorted(grads) == sorted(want)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL[dtype])
    if dtype == "f32":
        gaps = {n: _rel(g, want[n]) for n, g in grads.items()}
        worst = max(gaps, key=gaps.get)
        print(f"{case} f32: loss gap {abs(float(loss) / jloss - 1):.3e}, worst gradient "
              f"{worst} {gaps[worst]:.3e}")
        assert gaps[worst] < F32_GRAD_TOL, (worst, gaps[worst])
    else:
        f32, jf32 = _cfgs(case, "f32", remat=True)
        _, truth = _ref_loss_and_grads(j_build_model(jf32), jparams, batch)
        gaps = {n: (_rel(g, truth[n]), _rel(want[n], truth[n])) for n, g in grads.items()}
        over = {n: g for n, g in gaps.items() if g[0] > BF16_FACTOR * g[1] + BF16_FLOOR}
        worst = max(gaps, key=lambda n: gaps[n][0] / (gaps[n][1] + BF16_FLOOR))
        print(f"{case} bf16: loss gap {abs(float(loss) / jloss - 1):.3e}; from the "
              f"reference's float32, worst gradient {worst} {gaps[worst][0]:.3e} (the "
              f"reference's bf16 {gaps[worst][1]:.3e})")
        assert not over, over
    for n, g in grads.items():
        assert g.dtype == model.get_parameter(n).dtype and torch.isfinite(g).all(), n


@pytest.mark.parametrize("case", ["ssm", "hybrid", "encdec"])
def test_family_remat_gives_bit_equal_gradients(case):
    """``cfg.remat`` (each layer, block or encoder/decoder layer inside
    ``checkpoint``) changes no bit of the loss or of a gradient."""
    cfg, jcfg = _cfgs(case, "f32")
    _, _, jparams = _models(cfg, jcfg)
    batch = _batch(cfg)
    out = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat), device="cpu")
        model.load_state_dict(convert.lm_params_from_numpy(jparams))
        out.append(_grads(model, batch))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_training_forward_takes_the_training_routes(monkeypatch):
    """A hybrid training step runs its attention through ``_Flash`` and its
    scans through the chunked form under autograd, and launches nothing."""
    cfg, jcfg = _cfgs("hybrid", "f32")
    model, _, _ = _models(cfg, jcfg)
    routes = []
    flash, scan = attention._Flash.apply, ssm.ssd_chunked

    def recording_scan(*args, **kwargs):
        y, state = scan(*args, **kwargs)
        routes.append(("ssd", y.grad_fn is not None))
        return y, state

    def recording_flash(*args):
        routes.append(("flash", True))
        return flash(*args)

    monkeypatch.setattr(ssm, "ssd_chunked", recording_scan)
    monkeypatch.setattr(attention._Flash, "apply", recording_flash)
    build.LAUNCHES.reset()
    _grads(model, _batch(cfg))
    assert routes.count(("flash", True)) == 1
    assert routes.count(("ssd", True)) == cfg.block_period - 1
    assert not build.LAUNCHES.snapshot()


def _prefill_before(model, batch):
    """``EncDecLM.prefill`` as it was before ``_decoder_layer``: the
    decoder layer written out in the loop."""
    cfg = model.cfg
    with torch.no_grad():
        enc_out = model.encode(batch["frames"])
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s).expand(b, s)
        x = layers.embed_tokens(model.embed, tokens, cfg)
        cache = {}
        for name, seq in (("k", s), ("v", s), ("cross_k", enc_out.shape[1]),
                          ("cross_v", enc_out.shape[1])):
            shape, dtype = model.abstract_cache(b, seq)[name]
            cache[name] = torch.empty(shape, dtype=dtype)
        for i, lp in enumerate(model.dec_layers):
            hn = layers.rmsnorm(x, lp.ln1, cfg.rms_eps)
            q, k, v = attention.gqa_project_qkv(lp.self_attn, hn, positions, cfg)
            o = attention.blocked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                            k_chunk=cfg.attn_k_chunk)
            x = x + attention.output_projection(o, lp.self_attn.wo)
            hn = layers.rmsnorm(x, lp.ln_c, cfg.rms_eps)
            cq = attention._project(hn, lp.cross_attn.wq)
            ck, cv = model._cross_kv(lp, enc_out)
            co = attention.blocked_attention(cq, ck, cv, causal=False, chunk=cfg.attn_chunk,
                                             k_chunk=cfg.attn_k_chunk)
            x = x + attention.output_projection(co, lp.cross_attn.wo)
            x = x + layers.mlp(lp.ffn, layers.rmsnorm(x, lp.ln2, cfg.rms_eps))
            cache["k"][i], cache["v"][i], cache["cross_k"][i], cache["cross_v"][i] = k, v, ck, cv
        x = layers.rmsnorm(x, model.ln_f, cfg.rms_eps)
        return layers.output_logits(model.embed, x[:, -1:, :], cfg), cache


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encdec_prefill_is_unchanged(dtype):
    """``prefill`` through ``_decoder_layer``: logits and every cache entry
    bit-equal to the decoder layer written out."""
    cfg, jcfg = _cfgs("encdec", dtype)
    model, _, _ = _models(cfg, jcfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items() if k != "labels"}
    logits, cache = model.prefill(batch)
    want_logits, want_cache = _prefill_before(model, batch)
    assert torch.equal(logits, want_logits)
    assert sorted(cache) == sorted(want_cache)
    for name in cache:
        assert torch.equal(cache[name], want_cache[name]), name


# -- shapes, specs and counts ---------------------------------------------------------

LM_ARCHS = [a for a in configs.ARCH_IDS if isinstance(configs.get_config(a), ModelConfig)]


def _spec_table(tree):
    """{name: (shape, dtype name)} of a spec tree: the reference's
    ``ShapeDtypeStruct`` leaves or the port's (shape, dtype) pairs."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update({f"{key}.{k}": v for k, v in _spec_table(val).items()})
        elif isinstance(val, tuple):
            out[key] = (tuple(val[0]), str(val[1]).split(".")[-1])
        else:
            out[key] = (tuple(val.shape), np.dtype(val.dtype).name)
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_and_cache_axes_match_reference(arch):
    """``input_specs`` of each mode (and of two lengths: the encoder-decoder
    clamps its decoder's to 128) and ``cache_logical_axes`` of every arch's
    SMOKE equal the reference's, names, shapes and dtypes."""
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    jmodel = j_build_model(jcfg)
    for mode in ("train", "prefill", "decode"):
        for seq in (64, 4096):
            got = _spec_table(model.input_specs(3, seq, mode))
            assert got == _spec_table(jmodel.input_specs(3, seq, mode)), (mode, seq)
    if isinstance(cfg, ModelConfig):
        assert model.cache_logical_axes() == jmodel.cache_logical_axes()
        with pytest.raises(ValueError):
            model.input_specs(1, 8, "serve")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_active_params_and_param_count_match_reference(arch):
    """``param_count(cfg)`` and ``active_params()`` of every LM arch's full
    config equal the reference's, and no parameter is allocated: the
    count of a smoke config equals its built model's."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert param_count(cfg) == j_param_count(jcfg)
    assert cfg.active_params() == jcfg.active_params()
    assert cfg._num_moe_layers() == jcfg._num_moe_layers()
    smoke = configs.get_smoke_config(arch)
    built = build_model(smoke, device="cpu")
    assert param_count(smoke) == sum(p.numel() for p in built.parameters())
