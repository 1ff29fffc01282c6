"""The decoder LM's other families in the port against the reference package.

The six configs this slice brings -- the dense ``codeqwen1.5-7b`` (full
multi-head attention with QKV bias), ``qwen2-72b`` (GQA with QKV bias)
and ``llama3-405b``, the MLA + MoE ``deepseek-v2-236b``, the MoE
``kimi-k2-1t-a32b`` and the vision LM ``llava-next-mistral-7b`` -- at
their smoke sizes: ``CONFIG`` and ``SMOKE`` field by field, prefill
logits and cache (MLA's ``c_kv``/``k_rope`` among them) and 4 decode
steps against the reference in float32 and bf16, the vision frontend's
``image_embeds``, MLA's decode against its prefill, the ``qkv_bias``
branch with non-zero biases, the plain attention at MLA's head dim of
192, a ``convert`` round trip of each tree, the serve CLI and the
``BatchingServer``.  JAX's PRNG cannot be matched, so the reference's
weights are carried across with ``repro_torch.convert``; inputs are made
with numpy from seeds.  Tolerances are ``tests/test_torch_lm.py``'s,
float32's absolute bound taken relative to a tensor's scale (``_close``).
The reference runs compiled with XLA's excess precision off
(``test_torch_ssm._strict_jit``), so that it rounds bf16 intermediates
where the program says, as the port does: without qk_norm the smoke
weights saturate the softmax, and the default build's own bf16 logits
and caches then sit 0.08 to 3.2 of their rms from the strict build's,
while the port's sit within 0.02 of it (measured).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving.server import BatchingServer as JServer  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import ServerConfig as JServerConfig  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, build_model, common  # noqa: E402
from repro_torch.serving import BatchingServer, Request, ServerConfig  # noqa: E402
from test_torch_lm import BLOCKED_TOL, SWEEP_TOL, _model_close  # noqa: E402
from test_torch_ssm import _strict_jit  # noqa: E402

ARCHS = ["codeqwen1.5-7b", "qwen2-72b", "llama3-405b", "deepseek-v2-236b",
         "kimi-k2-1t-a32b", "llava-next-mistral-7b"]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
PROMPT = 24                   # at least llava-smoke's 16 patches


def _close(got, want, dtype):
    """``_model_close``, with float32's absolute bound taken relative to
    the tensor's scale: without qk_norm a key's entries reach ~8 at the
    smoke sizes, and a float32 sum in another order moves them by ~2e-5
    of that (measured up to 1.9e-4), which ``_model_close``'s fixed
    atol 1e-4 would refuse for entries near 0.  bf16: ``_model_close``'s
    10% of the rms."""
    if dtype == "f32":
        g, w = (np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                           np.float32) for x in (got, want))
        rms = float(np.sqrt(np.mean(np.square(w))))
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(1.0, rms))
    else:
        _model_close(got, want, dtype)


def _smoke(arch, dtype):
    td, jd = DTYPES[dtype]
    return (dataclasses.replace(configs.get_smoke_config(arch), param_dtype=td,
                                compute_dtype=td),
            dataclasses.replace(jconfigs.get_smoke_config(arch), param_dtype=jd,
                                compute_dtype=jd))


def _models(cfg, jcfg, seed=0, edit=None):
    """The reference's model and seeded weights (numpy leaves, passed
    through ``edit`` if given) and the port's model holding them."""
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    if edit is not None:
        jparams = edit(jparams)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_numpy(jparams))
    return model, jmodel, jax.tree.map(jnp.asarray, jparams)


def _prompt(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["image_embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model))).astype(np.float32)
    return batch


def _both(batch, cfg, jcfg):
    """A numpy batch as the port's and the reference's (image_embeds in
    each package's compute dtype)."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if "image_embeds" in batch:
        tb["image_embeds"] = tb["image_embeds"].to(cfg.compute_dtype)
        jb["image_embeds"] = jb["image_embeds"].astype(jcfg.compute_dtype)
    return tb, jb


def _same_fields(got, want, where):
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names, where
    for n in names:
        g, w = getattr(got, n), getattr(want, n)
        if dataclasses.is_dataclass(w):
            _same_fields(g, w, f"{where}.{n}")
        elif n.endswith("_dtype"):
            assert str(g) == f"torch.{np.dtype(w).name}", f"{where}.{n}"
        else:
            assert g == w, f"{where}.{n}"


# -- configs ------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_constants_match_reference(arch):
    """CONFIG and SMOKE equal the reference's field by field, the MoE and
    MLA configs too (dtypes by name); the arch is registered and served."""
    for getter in ("get_config", "get_smoke_config"):
        got, want = getattr(configs, getter)(arch), getattr(jconfigs, getter)(arch)
        _same_fields(got, want, f"{arch}.{getter}")
        assert got.q_per_kv() == want.q_per_kv()
    assert arch in configs.ARCH_IDS and arch in serve.LM_ARCHS


def test_arch_ids_are_the_reference_s_but_hybrid_and_enc_dec():
    """Every arch of the reference is the port's, in the reference's order."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS


# -- the models ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits and cache, then 4 decode steps' logits and the cache,
    within ``_close``; in float32 the greedy tokens are identical
    (bf16 feeds both the reference's tokens, as ``test_torch_lm`` does)."""
    cfg, jcfg = _smoke(arch, dtype)
    model, jmodel, jparams = _models(cfg, jcfg)
    tb, jb = _both(_prompt(cfg, 2, PROMPT, 11), cfg, jcfg)
    logits, cache = model.prefill(tb)
    jlogits, jcache = _strict_jit(jmodel.prefill)(jparams, jb)
    assert logits.shape == jlogits.shape == (2, 1, cfg.vocab_size)
    assert logits.dtype == cfg.compute_dtype
    _close(logits, jlogits, dtype)
    assert sorted(cache) == sorted(jcache) == (["c_kv", "k_rope"] if cfg.mla else ["k", "v"])
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape
        assert cache[name].dtype == cfg.compute_dtype
        _close(cache[name], jcache[name], dtype)

    decode = _strict_jit(jmodel.decode_step)
    pc, jc = model.init_cache(2, 12), jmodel.init_cache(2, 12)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    for pos in range(4):
        if dtype == "f32":
            assert tok.numpy().tolist() == np.asarray(jtok).tolist()
        else:
            tok = torch.from_numpy(np.array(jtok))
        lg, pc = model.decode_step({"token": tok, "pos": pos, "cache": pc})
        jlg, jc = decode(jparams, {"token": jtok, "pos": jnp.asarray(pos, jnp.int32),
                                   "cache": jc})
        _close(lg, jlg, dtype)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        jtok = jnp.argmax(jlg, axis=-1).astype(jnp.int32)
    for name in pc:
        _close(pc[name], jc[name], dtype)


def test_mla_decode_matches_prefill():
    """The reference's ``test_attention.py::test_mla_decode_matches_prefill``
    on the port (bf16 deepseek-smoke, the reference's weights and its
    tokens, ``jax.random.randint`` of key 5): the last prompt token
    decoded over the prefill's cache, padded to 16, gives the prefill's
    logits within the reference test's atol 0.1, rtol 0.05, and the
    reference's decode logits within ``_close``.  In float32, on tokens
    drawn with numpy, decode and prefill agree within 1e-4 of the logits'
    scale (measured 7e-6)."""
    for dtype in ("bf16", "f32"):
        cfg, jcfg = _smoke("deepseek-v2-236b", dtype)
        model, jmodel, jparams = _models(cfg, jcfg)
        if dtype == "bf16":
            toks = np.array(jax.random.randint(jax.random.PRNGKey(5), (1, 8), 0,
                                               cfg.vocab_size), np.int32)
        else:
            toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
        lp, cache = model.prefill({"tokens": torch.from_numpy(toks)})
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 8)) for k, v in cache.items()}
        ld, _ = model.decode_step({"token": torch.from_numpy(toks[:, -1:]), "pos": 7,
                                   "cache": cache})
        if dtype == "bf16":
            np.testing.assert_allclose(ld[:, 0].float().numpy(), lp[:, 0].float().numpy(),
                                       atol=0.1, rtol=0.05)
        else:
            _close(ld, lp, "f32")
        _, jcache = _strict_jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
        jcache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 8), (0, 0))) for k, v in jcache.items()}
        jld, _ = _strict_jit(jmodel.decode_step)(jparams, {
            "token": jnp.asarray(toks[:, -1:]), "pos": jnp.asarray(7, jnp.int32),
            "cache": jcache})
        _close(ld, jld, dtype)


def test_mla_decode_clamps_an_out_of_range_position_like_xla():
    """At pos >= the cache length XLA's dynamic_update_slice writes the
    last row of c_kv and k_rope; the port clamps the same way (float32)."""
    cfg, jcfg = _smoke("deepseek-v2-236b", "f32")
    model, jmodel, jparams = _models(cfg, jcfg)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    warm = {"c_kv": rng.standard_normal((2, 2, 6, 16)).astype(np.float32),
            "k_rope": rng.standard_normal((2, 2, 6, 8)).astype(np.float32)}
    pc = {k: torch.from_numpy(v.copy()) for k, v in warm.items()}
    jc = {k: jnp.asarray(v) for k, v in warm.items()}
    for pos in (6, 9):
        lg, pc = model.decode_step({"token": torch.from_numpy(tok), "pos": pos, "cache": pc})
        jlg, jc = _strict_jit(jmodel.decode_step)(jparams, {"token": jnp.asarray(tok),
                                               "pos": jnp.asarray(pos, jnp.int32), "cache": jc})
        _close(lg, jlg, "f32")
        for name in pc:
            _close(pc[name], jc[name], "f32")


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "qwen2-72b"])
def test_qkv_bias_branch_with_nonzero_biases(arch):
    """``bq``/``bk``/``bv`` start at zero (the reference's "zeros"
    initializer); with non-zero biases carried across, the port adds them
    before rope as the reference does: prefill logits and cache and one
    decode step within ``_close`` (float32), and the biases move
    the logits."""
    cfg, jcfg = _smoke(arch, "f32")
    assert cfg.qkv_bias and not cfg.qk_norm
    rng = np.random.default_rng(17)

    def biased(p):
        attn = dict(p["layers"]["attn"])
        for name in ("bq", "bk", "bv"):
            assert not attn[name].any(), f"{name} is not zero-initialised"
            attn[name] = rng.standard_normal(attn[name].shape).astype(attn[name].dtype)
        return {**p, "layers": {**p["layers"], "attn": attn}}

    model, jmodel, jparams = _models(cfg, jcfg, edit=biased)
    plain, _, _ = _models(cfg, jcfg)
    tb, jb = _both(_prompt(cfg, 2, 16, 3), cfg, jcfg)
    logits, cache = model.prefill(tb)
    jlogits, jcache = _strict_jit(jmodel.prefill)(jparams, jb)
    _close(logits, jlogits, "f32")
    for name in ("k", "v"):
        _close(cache[name], jcache[name], "f32")
    assert float((logits - plain.prefill(tb)[0]).abs().max()) > 1e-3
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    lg, _ = model.decode_step({"token": tok, "pos": 16,
                               "cache": {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
                                         for k, v in cache.items()}})
    jlg, _ = _strict_jit(jmodel.decode_step)(jparams, {
        "token": jnp.asarray(tok.numpy()), "pos": jnp.asarray(16, jnp.int32),
        "cache": {k: jnp.pad(v, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0)))
                  for k, v in jcache.items()}})
    _close(lg, jlg, "f32")


def test_vision_frontend_takes_image_embeds():
    """llava-smoke (float32): the first 16 positions are the image rows.
    The logits with image_embeds match the reference's, differ from the
    tokens-only prefill (which also matches the reference), and a prompt
    shorter than the patches raises."""
    cfg, jcfg = _smoke("llava-next-mistral-7b", "f32")
    model, jmodel, jparams = _models(cfg, jcfg)
    batch = _prompt(cfg, 2, PROMPT, 4)
    tb, jb = _both(batch, cfg, jcfg)
    x = model.embed_inputs(tb)
    assert torch.equal(x[:, :cfg.num_patches], tb["image_embeds"])
    assert torch.equal(x[:, cfg.num_patches:],
                       model.embed_inputs({"tokens": tb["tokens"]})[:, cfg.num_patches:])
    with_img, _ = model.prefill(tb)
    _close(with_img, _strict_jit(jmodel.prefill)(jparams, jb)[0], "f32")
    text, _ = model.prefill({"tokens": tb["tokens"]})
    _close(text, _strict_jit(jmodel.prefill)(jparams, {"tokens": jb["tokens"]})[0], "f32")
    assert float((with_img - text).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="no room for 16 image patches"):
        model.prefill({"tokens": tb["tokens"][:, :8],
                       "image_embeds": tb["image_embeds"]})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("branch", ["blocked", "dense"])
def test_blocked_attention_at_mla_head_dim(branch, dtype):
    """The plain ``blocked_attention`` at D = 192 (128 nope + 64 rope) with
    v padded from 128 as MLA pads it and MLA's scale, against the
    reference's, within ``BLOCKED_TOL``; the padded columns stay 0.  The
    plain ``flash_attention`` at D = 192 against the reference's oracle
    within ``SWEEP_TOL``."""
    rng = np.random.default_rng(192)
    b, s, h = 2, 16, 4
    q = rng.standard_normal((b, s, h, 192)).astype(np.float32)
    k = rng.standard_normal((b, s, h, 192)).astype(np.float32)
    v = np.zeros((b, s, h, 192), np.float32)
    v[..., :128] = rng.standard_normal((b, s, h, 128))
    td, jd = DTYPES[dtype]
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    chunk = 8 if branch == "blocked" else 6         # 6 does not divide 16: dense
    kw = dict(causal=True, chunk=chunk, k_chunk=4 * chunk, softmax_scale=1 / np.sqrt(192))
    got = attention.blocked_attention(tq, tk, tv, **kw)
    tol = BLOCKED_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jattn.blocked_attention(jq, jk, jv, **kw), np.float32),
                               rtol=tol, atol=tol)
    assert not got[..., 128:].any()
    plain = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2))
    want = jref.flash_attention(*(a.transpose(0, 2, 1, 3) for a in (jq, jk, jv)))
    np.testing.assert_allclose(plain.float().numpy(), np.asarray(want, np.float32),
                               rtol=SWEEP_TOL[dtype], atol=SWEEP_TOL[dtype])


# -- parameters, convert, init -------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips(arch):
    """The reference's bf16 tree (float32 norms and router beside bf16
    experts) crosses to the port and back byte for byte, path for path;
    the caches cross leaf by leaf."""
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    model, jmodel, jparams = _models(cfg, jcfg)
    back = convert.lm_params_to_numpy(model)
    jflat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    bflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in jflat] == [p for p, _ in bflat]
    for (path, a), (_, b) in zip(jflat, bflat):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    if cfg.moe:
        assert back["layers"]["ffn"]["router"].dtype == np.float32
        assert back["layers"]["ffn"]["wi_gate"].dtype.name == "bfloat16"
    jcache = jax.tree.map(np.asarray, jmodel.init_cache(2, 4))
    cache = convert.lm_cache_from_numpy(jcache)
    assert sorted(cache) == sorted(jcache)
    for name, t in cache.items():
        assert tuple(t.shape) == jcache[name].shape and t.dtype == cfg.compute_dtype


def test_init_draws_a_large_leaf_in_slices(monkeypatch):
    """A leaf of more than ``DRAW_ELEMENTS`` elements is drawn in slices
    along its first axis: seeded, with the initializer's std, and the
    slices' draws are distinct."""
    monkeypatch.setattr(common, "DRAW_ELEMENTS", 1000)
    spec = common.ParamSpec((40, 30, 20), torch.float32, "scaled")
    a, b = torch.empty(spec.shape), torch.empty(spec.shape)
    common.init_leaf(a, spec, torch.Generator().manual_seed(3))
    common.init_leaf(b, spec, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert abs(a.std().item() - 1 / np.sqrt(40)) < 0.01
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[:1], a[1:2])


# -- serving ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_smoke_cpu(arch, capsys):
    rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "20", "--decode-steps", "4", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert rc == 0
    name = configs.get_smoke_config(arch).name
    assert f"arch={name} prefill_s=" in out and "finite logits: True" in out
    assert len(out.split("sampled tokens[0]: [")[1].split("]")[0].split(",")) == 5


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_batching_server_matches_reference(arch):
    """The reference's and the port's BatchingServer (float32 smoke, the
    reference's seed-0 weights in both) give the same tokens for two
    requests sharing the slots: the MLA cache and the MoE FFN through the
    server as it is."""
    cfg, jcfg = _smoke(arch, "f32")
    jserver = JServer(jcfg, JServerConfig(slots=2, cache_len=32), seed=0)
    server = BatchingServer(cfg, ServerConfig(slots=2, cache_len=32), device="cpu",
                            params=convert.lm_params_from_numpy(
                                jax.tree.map(np.asarray, jserver.params)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32) for _ in range(2)]
    outs = []
    for srv, req in ((jserver, JRequest), (server, Request)):
        for i, p in enumerate(prompts):
            srv.submit(req(rid=i, prompt=p, max_new_tokens=6))
        outs.append({r.rid: list(r.output) for r in srv.run()})
    assert outs[1] == outs[0]
    assert all(len(o) == 6 for o in outs[1].values())
