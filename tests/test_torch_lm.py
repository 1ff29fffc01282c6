"""The port's LM serving slice (dense GQA, ``qwen3-smoke``) against the
reference package.

The plain ``flash_attention``, ``blocked_attention`` (both of its
branches), decode attention, the layers, ``prefill``/``decode_step``
logits and caches, the serve CLI and the ``BatchingServer`` go through
both packages on the same inputs, made with numpy from a seed.  JAX's
PRNG cannot be matched, so the reference's initial weights are carried
across with ``repro_torch.convert``.  Each test states its tolerance:
float32 differs only by the order of sums; bfloat16 also by where the two
frameworks round (one bf16 ulp is 2^-8 relative).  The CUDA kernel has
no CPU mode: its test is in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving.server import BatchingServer as JServer  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import ServerConfig as JServerConfig  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, build_model, layers  # noqa: E402
from repro_torch.models.common import MLAConfig, MoEConfig, SSMConfig  # noqa: E402
from repro_torch.serving import BatchingServer, Request, ServerConfig  # noqa: E402

SMOKE = configs.get_smoke_config("qwen3-8b")
J_SMOKE = jconfigs.get_smoke_config("qwen3-8b")
F32 = dataclasses.replace(SMOKE, param_dtype=torch.float32, compute_dtype=torch.float32)
J_F32 = dataclasses.replace(J_SMOKE, param_dtype=jnp.float32, compute_dtype=jnp.float32)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# the reference's own kernel sweep (tests/test_kernels.py) holds its Pallas
# kernel to its dense oracle within these, on unit-normal operands
SWEEP_TOL = {"f32": 2e-5, "bf16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """One float32 numpy array as (torch, jax) arrays of ``dtype``; both
    round float32 to bfloat16 to nearest even, so the two start equal."""
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a, jd)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# -- configs ------------------------------------------------------------------------


def test_qwen3_constants_match_reference():
    """CONFIG and SMOKE equal the reference's field by field (dtypes by
    name: torch's bfloat16 for jnp's)."""
    for getter in ("get_config", "get_smoke_config"):
        got = getattr(configs, getter)("qwen3-8b")
        want = getattr(jconfigs, getter)("qwen3-8b")
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names
        for n in names:
            if n.endswith("_dtype"):
                assert str(getattr(got, n)) == f"torch.{np.dtype(getattr(want, n)).name}", n
            else:
                assert getattr(got, n) == getattr(want, n), n
        assert got.q_per_kv() == want.q_per_kv()
        assert (got.attention_free, got.sub_quadratic) == (want.attention_free,
                                                          want.sub_quadratic)
    assert "qwen3-8b" in configs.ARCH_IDS


# -- attention kernels ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,h,s,d,causal", [
    (1, 2, 128, 64, True), (2, 4, 256, 64, True), (2, 2, 256, 128, False),
])
def test_plain_flash_attention_matches_pallas_and_ref(b, h, s, d, causal, dtype):
    """The reference's sweep: the port's plain version against the Pallas
    kernel (interpret mode) and the reference's oracle, within the sweep's
    tolerance (2e-5 f32, 2e-2 bf16)."""
    rng = np.random.default_rng(s + d)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    (tq, jq), (tk, jk), (tv, jv) = (_pair(a, dtype) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == DTYPES[dtype][0] and got.shape == (b, h, s, d)
    tol = SWEEP_TOL[dtype]
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal, use_pallas=True), tol)
    _close(got, jref.flash_attention(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_flash_attention_gqa_and_ragged(dtype):
    """GQA by ``repeat_interleave`` equals the reference oracle on
    ``jnp.repeat``-expanded K/V; causal with T != S; tolerance as the
    sweep's."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 8, 37, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 45, 32)).astype(np.float32) for _ in range(2))
    (tq, jq), (tk, jk), (tv, jv) = (_pair(a, dtype) for a in (q, k, v))
    for causal in (True, False):
        got = ops.flash_attention(tq, tk, tv, causal=causal)
        want = jref.flash_attention(jq, jnp.repeat(jk, 4, axis=1), jnp.repeat(jv, 4, axis=1),
                                    causal=causal)
        _close(got, want, SWEEP_TOL[dtype])


# blocked_attention: the blocked branch with GQA and several q and k blocks;
# the dense branch where a chunk does not divide S; T != S non-causal
BLOCKED_CASES = {
    "blocked_gqa": dict(b=2, s=16, t=16, h=4, kvh=2, d=32, chunk=8, k_chunk=4, causal=True),
    "blocked_mha_one_block": dict(b=1, s=8, t=8, h=2, kvh=2, d=64, chunk=1024,
                                  k_chunk=4096, causal=True),
    "dense_fallback": dict(b=2, s=12, t=12, h=4, kvh=2, d=32, chunk=8, k_chunk=8, causal=True),
    "t_ne_s_full": dict(b=1, s=8, t=24, h=4, kvh=1, d=32, chunk=4, k_chunk=8, causal=False),
}
# float32: the same blocked algorithm in both, only sums' order differs
BLOCKED_TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(BLOCKED_CASES))
def test_blocked_attention_matches_reference(case, dtype):
    c = BLOCKED_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((c["b"], c["s"], c["h"], c["d"])).astype(np.float32)
    k, v = (rng.standard_normal((c["b"], c["t"], c["kvh"], c["d"])).astype(np.float32)
            for _ in range(2))
    (tq, jq), (tk, jk), (tv, jv) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(causal=c["causal"], chunk=c["chunk"], k_chunk=c["k_chunk"])
    got = attention.blocked_attention(tq, tk, tv, **kw)
    want = jattn.blocked_attention(jq, jk, jv, **kw)
    assert got.shape == want.shape and got.dtype == DTYPES[dtype][0]
    _close(got, want, BLOCKED_TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [0, 5, 15])
def test_decode_attention_matches_reference(pos, dtype):
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 16, 2, 32)).astype(np.float32) for _ in range(2))
    (tq, jq), (tk, jk), (tv, jv) = (_pair(a, dtype) for a in (q, kc, vc))
    got = attention.decode_attention(tq, tk, tv, pos)
    want = jattn.decode_attention(jq, jk, jv, jnp.asarray(pos, jnp.int32))
    _close(got, want, BLOCKED_TOL[dtype])


# -- layers ------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layers_match_reference(dtype):
    """rmsnorm, apply_rope, mlp, embed_tokens and output_logits.  float32
    within 1e-5; bfloat16 within 2e-2 (products rounded to bf16, one ulp
    apart where the two frameworks' sums round differently)."""
    tol = 1e-5 if dtype == "f32" else 2e-2
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    tx, jx = _pair(x, dtype)
    _close(layers.rmsnorm(tx, torch.from_numpy(scale), 1e-6),
           jlayers.rmsnorm(jx, jnp.asarray(scale), 1e-6), tol)

    heads = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 9, 11, 13, 500]], np.int32)
    th, jh = _pair(heads, dtype)
    _close(layers.apply_rope(th, torch.from_numpy(pos), 1e6),
           jlayers.apply_rope(jh, jnp.asarray(pos), 1e6), tol)
    _close(layers.rope_frequencies(32, 1e6), jlayers.rope_frequencies(32, 1e6), 1e-6)

    w = {n: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
         for n, shape in (("wi_gate", (128, 256)), ("wi_up", (128, 256)), ("wo", (256, 128)))}
    tw = {n: _pair(a, dtype)[0] for n, a in w.items()}
    jw = {n: _pair(a, dtype)[1] for n, a in w.items()}
    _close(layers.mlp(tw, tx), jlayers.mlp(jw, jx), tol)

    cfg, jcfg = (F32, J_F32) if dtype == "f32" else (SMOKE, J_SMOKE)
    for tie in (False, True):
        emb = {"tok": (0.02 * rng.standard_normal((512, 128))).astype(np.float32),
               "out": (rng.standard_normal((128, 512)) / np.sqrt(128)).astype(np.float32)}
        te = {n: _pair(a, dtype)[0] for n, a in emb.items()}
        je = {n: _pair(a, dtype)[1] for n, a in emb.items()}
        tokens = rng.integers(0, 512, (2, 5)).astype(np.int32)
        xe = layers.embed_tokens(te, torch.from_numpy(tokens), cfg)
        assert xe.dtype == cfg.compute_dtype
        _close(xe, jlayers.embed_tokens(je, jnp.asarray(tokens), jcfg), 0)
        c = dataclasses.replace(cfg, tie_embeddings=tie)
        jc = dataclasses.replace(jcfg, tie_embeddings=tie)
        _close(layers.output_logits(te, tx, c), jlayers.output_logits(je, jx, jc), tol)


# -- the model --------------------------------------------------------------------------


def _models(cfg, jcfg, seed=0):
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams)))
    return model, jmodel, jparams


# tolerances of the whole model against the reference.  float32: sums in
# another order only (measured: 5e-6 of the logits' scale).  bfloat16:
# every product is rounded to bf16 (2^-8 relative) and a one-ulp flip of
# an activation moves the next layer's input; after 2 layers the largest
# difference of a logit or cache tensor measured 4-5% of its rms, and the
# bound is 10% of the rms.
def _model_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        rms = float(np.sqrt(np.mean(np.square(want))))
        assert np.abs(got - want).max() <= 0.1 * rms


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits and cache, then 4 greedy decode steps' logits and
    the cache; in float32 the greedy tokens are identical."""
    cfg, jcfg = (F32, J_F32) if dtype == "f32" else (SMOKE, J_SMOKE)
    model, jmodel, jparams = _models(cfg, jcfg)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    logits, cache = model.prefill({"tokens": torch.from_numpy(tokens)})
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    assert logits.shape == jlogits.shape == (2, 1, cfg.vocab_size)
    assert logits.dtype == cfg.compute_dtype
    _model_close(logits, jlogits, dtype)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape == (2, 2, 16, 2, 32)
        _model_close(cache[name], jcache[name], dtype)

    decode = jax.jit(jmodel.decode_step)
    pc, jc = model.init_cache(2, 12), jmodel.init_cache(2, 12)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    if dtype == "f32":
        assert tok.numpy().tolist() == np.asarray(jtok).tolist()
    else:            # bf16 logits tie often: feed both the reference's tokens
        tok = torch.from_numpy(np.asarray(jtok))
    for pos in range(4):
        lg, pc = model.decode_step({"token": tok, "pos": pos, "cache": pc})
        jlg, jc = decode(jparams, {"token": jtok, "pos": jnp.asarray(pos, jnp.int32),
                                   "cache": jc})
        _model_close(lg, jlg, dtype)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        jtok = jnp.argmax(jlg, axis=-1).astype(jnp.int32)
        if dtype == "f32":
            assert tok.numpy().tolist() == np.asarray(jtok).tolist()
        else:        # keep both on one token stream, so the next step compares like inputs
            tok = torch.from_numpy(np.asarray(jtok))
    for name in ("k", "v"):
        _model_close(pc[name], jc[name], dtype)


def test_decode_clamps_an_out_of_range_position_like_xla():
    """At pos == cache length XLA's dynamic_update_slice writes the last
    row; the port clamps the same way instead of raising (float32)."""
    model, jmodel, jparams = _models(F32, J_F32)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, F32.vocab_size, (2, 1)).astype(np.int32)
    warm = rng.standard_normal((2, 2, 6, 2, 32)).astype(np.float32)
    pc = {"k": torch.from_numpy(warm.copy()), "v": torch.from_numpy(-warm)}
    jc = {"k": jnp.asarray(warm), "v": jnp.asarray(-warm)}
    for pos in (6, 9):
        lg, pc = model.decode_step({"token": torch.from_numpy(tok), "pos": pos, "cache": pc})
        jlg, jc = jmodel.decode_step(jparams, {"token": jnp.asarray(tok),
                                               "pos": jnp.asarray(pos, jnp.int32), "cache": jc})
        _model_close(lg, jlg, "f32")
        for name in ("k", "v"):
            _model_close(pc[name], jc[name], "f32")


def test_convert_round_trips_and_init_is_seeded():
    """bf16 leaves cross through their bits both ways; a model's init is a
    function of its seed with the reference's initializers."""
    model, _, jparams = _models(SMOKE, J_SMOKE)
    back = convert.lm_params_to_numpy(model)
    jflat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    bflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in jflat] == [p for p, _ in bflat]
    for (path, a), (_, b) in zip(jflat, bflat):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path

    a = build_model(SMOKE, device="cpu").init(3)
    b = build_model(SMOKE, device="cpu").init(3)
    c = build_model(SMOKE, device="cpu").init(4)
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith(("norm", "ln1", "ln2", "ln_f")):
            assert torch.equal(pa, torch.ones_like(pa)), name
        else:
            assert not torch.equal(pa, pc), name
    # "scaled" layer leaves: std 1/sqrt(shape[0]) of the stacked leaf, i.e.
    # of the number of layers; the output projection's fan-in is d_model
    wq = torch.stack([layer.attn.wq.float() for layer in a.layers])
    assert abs(wq.std().item() - 1 / np.sqrt(SMOKE.num_layers)) < 0.02
    assert abs(a.embed.out.float().std().item() - 1 / np.sqrt(SMOKE.d_model)) < 0.005
    assert abs(a.embed.tok.float().std().item() - 0.02) < 0.001


# -- serving --------------------------------------------------------------------------------


def test_serve_main_smoke_cpu(capsys):
    rc = serve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "8", "--decode-steps", "4", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "arch=qwen3-smoke prefill_s=" in out and "decode_tok_per_s=" in out
    assert "finite logits: True" in out
    assert len(out.split("sampled tokens[0]: [")[1].split("]")[0].split(",")) == 5


def _serve_both(prompts, slots=2, new_tokens=6):
    """The reference's and the port's BatchingServer (float32 smoke, the
    reference's seed-0 weights in both) on the same requests."""
    jserver = JServer(J_F32, JServerConfig(slots=slots, cache_len=32), seed=0)
    server = BatchingServer(F32, ServerConfig(slots=slots, cache_len=32), device="cpu",
                            params=convert.lm_params_from_numpy(
                                jax.tree.map(np.asarray, jserver.params)))
    outs = []
    for srv, req in ((jserver, JRequest), (server, Request)):
        for i, p in enumerate(prompts):
            srv.submit(req(rid=i, prompt=p, max_new_tokens=new_tokens))
        done = srv.run()
        outs.append({r.rid: list(r.output) for r in done})
        report = srv.latency_report(done)
        assert report["requests"] == len(prompts)
    return outs


def test_batching_server_matches_reference_with_shared_slots():
    """Two requests sharing the slots give the reference's outputs token
    for token (float32), and request 0's output changes once a second
    request is admitted beside it: the reference's cache overwrite, which
    the port keeps."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, F32.vocab_size, 8).astype(np.int32) for _ in range(2)]
    want, got = _serve_both(prompts)
    assert got == want
    assert all(len(o) == 6 for o in got.values())
    want_alone, got_alone = _serve_both(prompts[:1])
    assert got_alone == want_alone
    assert got_alone[0] != got[0]


def test_latency_report_fields():
    reqs = [Request(rid=0, prompt=np.zeros(2, np.int32), output=[1, 2], submitted_s=1.0,
                    first_token_s=1.5, done_s=3.0),
            Request(rid=1, prompt=np.zeros(2, np.int32), output=[3], submitted_s=2.0,
                    first_token_s=2.25, done_s=2.5)]
    jreqs = [JRequest(**dataclasses.asdict(r)) for r in reqs]
    assert BatchingServer.latency_report(reqs) == JServer.latency_report(jreqs)


# -- what the port does not have, and the device contract ----------------------------------


def _reference_change(change):
    """A config change of the port's as the reference's (its MoE, MLA and
    SSM config types, jnp dtypes)."""
    from repro.models.common import MLAConfig as JMLAConfig
    from repro.models.common import MoEConfig as JMoEConfig
    from repro.models.common import SSMConfig as JSSMConfig

    out = dict(change)
    if "moe" in change:
        out["moe"] = JMoEConfig(**dict(dataclasses.asdict(change["moe"]),
                                       router_dtype=jnp.float32))
    if "mla" in change:
        out["mla"] = JMLAConfig(**dataclasses.asdict(change["mla"]))
    if "ssm" in change:
        out["ssm"] = JSSMConfig(**dataclasses.asdict(change["ssm"]))
    return out


@pytest.mark.parametrize("change", [
    dict(moe=MoEConfig(num_experts=4, top_k=2, d_ff=64)),
    dict(mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
                       v_head_dim=16)),
    dict(family="hybrid", ssm=SSMConfig(), block_period=2, attn_index=1),
    dict(family="hybrid", block_period=2),
    dict(encoder_layers=2),
    dict(frontend="vision", num_patches=4),
    dict(frontend="audio"),
    dict(encoder_layers=2, frontend="audio"),
])
def test_build_model_raises_for_unported_families(change):
    """Every family is ported and every config the reference builds
    builds: the model has the reference's parameter names, shapes and
    dtypes (a leaf stacked on a leading axis of n layers or blocks is
    each one's (...)).  A feature the model does not take is ignored, as
    the reference ignores it: the audio frontend on a decoder-only config
    builds the reference's decoder, which never reads the frames.  A
    hybrid config without an ``SSMConfig`` raises ``ValueError``, where
    the reference's own build fails."""
    cfg = dataclasses.replace(SMOKE, **change)
    if change.get("family") == "hybrid" and "ssm" not in change:
        with pytest.raises(ValueError, match="needs family 'hybrid', an SSMConfig"):
            build_model(cfg, device="cpu")
        return
    _assert_reference_specs(build_model(cfg, device="cpu"), change)


def _assert_reference_specs(model, change):
    """``model``'s state dict has the names, shapes and dtypes of the
    reference's ``param_specs`` for ``SMOKE`` with ``change``."""
    specs = j_build_model(dataclasses.replace(J_SMOKE, **_reference_change(change))
                          ).param_specs()
    want = {}
    for name, spec in convert.flatten(specs).items():
        stack, _, rest = name.partition(".")
        if stack in convert.LM_STACKS:
            for i in range(spec.shape[0]):
                want[f"{stack}.{i}.{rest}"] = (spec.shape[1:], spec.dtype)
        else:
            want[name] = (spec.shape, spec.dtype)
    got = {n: (tuple(p.shape), p.dtype) for n, p in model.state_dict().items()}
    assert sorted(got) == sorted(want)
    for n, (shape, dtype) in want.items():
        assert got[n] == (tuple(shape), getattr(torch, np.dtype(dtype).name)), n


def test_build_model_builds_ssm_family():
    """Family "ssm" (pure Mamba-2) is ported: ``build_model`` returns an
    ``SSMLM``, and one with features an SSM model does not take (MoE,
    MLA, the vision frontend) builds the reference's SSM parameter tree
    and ignores them, as the reference does."""
    from repro_torch.models import SSMLM

    ssm_change = dict(family="ssm", ssm=SSMConfig(d_state=16, head_dim=16))
    model = build_model(dataclasses.replace(SMOKE, **ssm_change), device="cpu")
    assert isinstance(model, SSMLM)
    assert sorted(model.abstract_cache(2, 8)) == ["conv_B", "conv_C", "conv_x", "state"]
    _assert_reference_specs(model, ssm_change)
    extra = dict(ssm_change, moe=MoEConfig(num_experts=4, top_k=2, d_ff=64),
                 mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                               qk_rope_dim=8, v_head_dim=16),
                 frontend="vision", num_patches=4)
    model = build_model(dataclasses.replace(SMOKE, **extra), device="cpu")
    assert isinstance(model, SSMLM)
    assert sorted(model.abstract_cache(2, 8)) == ["conv_B", "conv_C", "conv_x", "state"]
    _assert_reference_specs(model, extra)


def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_model(SMOKE)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        BatchingServer(SMOKE, ServerConfig(slots=1, cache_len=8))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        serve.main(["--smoke"])


class _Elsewhere:
    """A stand-in for a tensor on a device that is neither CPU, CUDA nor
    ``meta`` (the dispatchers read only its shape and device)."""

    def __init__(self, t):
        self.shape, self.dtype = t.shape, t.dtype
        self.device = torch.device("xpu")
        self.requires_grad = False


def test_flash_wrappers_refuse_cpu_and_other_devices():
    """No silent fallback: the kernel's wrappers take CUDA tensors only,
    and the dispatcher refuses a device that is neither CPU, CUDA nor
    ``meta``; on ``meta`` both give an empty result of the kernel's shape."""
    q = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kflash.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kflash.flash_attention(q, q, q)
    meta = q.to("meta")
    other = _Elsewhere(meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(other, other, other)
    with pytest.raises(ValueError, match="no attention for device"):
        attention.blocked_attention(other, other, other)
    assert ops.flash_attention(meta, meta, meta).shape == meta.shape
    out = attention.blocked_attention(meta, meta, meta)
    assert (out.device.type, out.shape) == ("meta", meta.shape)
