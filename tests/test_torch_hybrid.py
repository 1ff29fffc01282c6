"""The hybrid family (``HybridLM``, ``jamba-1.5-large-398b``) in the port
against the reference package.

``jamba-smoke`` (one block of 8 sublayers: attention at index 4, Mamba-2
mixers elsewhere, MoE FFNs at the odd indices, the SSM at N = 16) and the
same at two blocks (``num_layers`` 16, so the leaves and the cache are
stacked over blocks): ``CONFIG`` and ``SMOKE`` field by field, parameter
names, shapes and dtypes against the reference's ``param_specs``, prefill
logits and every cache entry, decode steps on the prefill's cache and on
``serve``'s fresh zero cache, decode continuing the prefill (the
reference's ``test_ssm.py::test_jamba_decode_continues_prefill``), the
``moe_period`` semantics (0 or 1 gives no MoE sublayer), ``convert``
round trips, the reference's per-arch smoke (``test_models_smoke.py``)
and the serve CLI.  JAX's PRNG cannot be matched, so the reference's
weights are carried across with ``repro_torch.convert``; inputs are made
with numpy from seeds, and the reference runs compiled without excess
precision (``test_torch_ssm._strict_jit``), as the other LM families are
held.  The model-level comparisons are held in relative norm
(``_held``): the SSM state is heavy-tailed (its largest entries ~20x its
rms at these weights, whose "scaled" fan-in is the block count, 1 or
2), so a bound on the largest entry over the rms says little.  float32
within 1e-4 (measured up to 4e-5), each entry also within 5e-3 of the
rms (measured up to 1.7e-3, the state: the cumsum of dt*A is float64 in
the port, float32 in the reference); bf16 within 0.1 (measured up to
0.045, after 16 sublayers of bf16 roundings that differ by framework;
the reference's own default build sits up to 0.13 from its strict one).
Elsewhere ``test_torch_lm_families._close``'s tolerances.
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
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import HybridLM, build_model  # noqa: E402
from test_torch_lm_families import DTYPES, _close, _models, _same_fields  # noqa: E402
from test_torch_ssm import _strict_jit  # noqa: E402

ARCH = "jamba-1.5-large-398b"
PROMPT = 64                   # two SSD chunks of jamba-smoke's 32
NORM_TOL = {"f32": 1e-4, "bf16": 0.1}       # ||got - want|| / ||want||
BLOCKS = {"one_block": {}, "two_blocks": {"num_layers": 16}}


def _cfgs(dtype, **change):
    td, jd = DTYPES[dtype]
    cfg = configs.get_smoke_config(ARCH)
    jcfg = jconfigs.get_smoke_config(ARCH)
    return (dataclasses.replace(cfg, param_dtype=td, compute_dtype=td, **change),
            dataclasses.replace(jcfg, param_dtype=jd, compute_dtype=jd, **change))


def _spec_table(specs):
    """The reference's specs as the port's state-dict names: a stacked
    leaf (n, ...) as n leaves (...)."""
    want = {}
    for name, spec in convert.flatten(specs).items():
        stack, _, rest = name.partition(".")
        if stack in convert.LM_STACKS:
            for i in range(spec.shape[0]):
                want[f"{stack}.{i}.{rest}"] = (tuple(spec.shape[1:]), np.dtype(spec.dtype).name)
        else:
            want[name] = (tuple(spec.shape), np.dtype(spec.dtype).name)
    return want


def _state_table(model):
    return {n: (tuple(p.shape), str(p.dtype).split(".")[-1])
            for n, p in model.state_dict().items()}


def _held(got, want, dtype, norm_tol=NORM_TOL):
    """``got`` within ``norm_tol[dtype]`` of ``want`` in relative norm, and
    in float32 every entry within 5e-3 of want's rms."""
    got, want = (np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                            np.float32) for x in (got, want))
    assert got.shape == want.shape
    diff = got - want
    assert np.linalg.norm(diff) <= norm_tol[dtype] * np.linalg.norm(want)
    if dtype == "f32":
        assert np.abs(diff).max() <= 5e-3 * np.sqrt(np.mean(np.square(want)))


# -- configs and parameters ------------------------------------------------------------


def test_constants_match_reference():
    """CONFIG and SMOKE equal the reference's field by field, the MoE and
    SSM configs too (dtypes by name); the arch is registered and served."""
    for getter in ("get_config", "get_smoke_config"):
        _same_fields(getattr(configs, getter)(ARCH), getattr(jconfigs, getter)(ARCH),
                     f"{ARCH}.{getter}")
    assert ARCH in configs.ARCH_IDS and ARCH in serve.LM_ARCHS
    assert isinstance(build_model(configs.get_smoke_config(ARCH), device="cpu"), HybridLM)


@pytest.mark.parametrize("change", [{}, {"num_layers": 16}, {"moe_period": 1},
                                    {"moe_period": 0}, {"moe_period": 4, "attn_index": 0}])
def test_param_specs_match_reference(change):
    """Parameter names, shapes and dtypes against the reference's
    ``param_specs`` (bf16 smoke; two blocks; ``moe_period`` 1, 0 and 4),
    every leaf of ``blocks`` stacked over the blocks."""
    cfg, jcfg = _cfgs("bf16", **change)
    model = build_model(cfg, device="cpu")
    want = _spec_table(j_build_model(jcfg).param_specs())
    assert _state_table(model) == want
    assert len(model.blocks) == cfg.num_layers // cfg.block_period


@pytest.mark.parametrize("moe_period", [0, 1])
def test_moe_period_below_two_has_no_moe_sublayer(moe_period):
    """``_is_moe`` is ``i % max(moe_period, 1) == 1``, as in the
    reference: ``moe_period`` 0 or 1 gives no MoE sublayer, though the
    config field's comment reads "0 = all".  With 2 (the published
    value) the odd indices are MoE.  The float32 prefill of a
    ``moe_period`` 1 model matches the reference's."""
    cfg, jcfg = _cfgs("f32", moe_period=moe_period)
    model = build_model(cfg, device="cpu")
    jmodel = j_build_model(jcfg)
    assert [model._is_moe(i) for i in range(8)] == [jmodel._is_moe(i) for i in range(8)]
    assert not any(model._is_moe(i) for i in range(8))
    assert not any(n.endswith("ffn.router") for n in model.state_dict())
    default = HybridLM(configs.get_smoke_config(ARCH), device="cpu")
    assert [i for i in range(8) if default._is_moe(i)] == [1, 3, 5, 7]
    model, jmodel, jparams = _models(cfg, jcfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    logits, _ = model.prefill({"tokens": torch.from_numpy(tokens)})
    _close(logits, _strict_jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})[0],
           "f32")


@pytest.mark.parametrize("change", [
    dict(block_period=0), dict(block_period=3), dict(ssm=None), dict(attn_index=8),
])
def test_hybrid_config_errors(change):
    """A hybrid needs an ``SSMConfig`` and ``block_period > 0`` dividing
    ``num_layers``, with ``attn_index`` inside the block: ``ValueError``."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **change)
    with pytest.raises(ValueError, match="a hybrid model needs"):
        build_model(cfg, device="cpu")


def test_init_draws_stacked_leaves_with_the_block_count_as_fan_in():
    """``init`` draws a stacked leaf with the reference's "scaled" fan-in,
    ``shape[0]`` of the stacked leaf: the number of blocks.  Seeded."""
    cfg, _ = _cfgs("f32", num_layers=32)
    a = build_model(cfg, device="cpu").init(3)
    b = build_model(cfg, device="cpu").init(3)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    wq = torch.stack([blk.sub4.mixer.wq for blk in a.blocks])
    assert abs(float(wq.detach().std()) - 1 / np.sqrt(4)) < 0.01


# -- prefill and decode ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("blocks", sorted(BLOCKS))
def test_prefill_and_decode_match_reference(blocks, dtype):
    """Prefill logits and every cache entry (``k``/``v`` over the blocks,
    the SSM ``state`` and conv tails over blocks and SSM sublayers), then
    3 decode steps on the prefill's cache (K/V padded by 4 rows) and 3 on
    ``serve``'s fresh zero cache of 12 rows, logits and the final caches
    against the reference's within ``_held``, fed the reference's
    tokens."""
    cfg, jcfg = _cfgs(dtype, **BLOCKS[blocks])
    model, jmodel, jparams = _models(cfg, jcfg)
    nb = cfg.num_layers // cfg.block_period
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    logits, cache = model.prefill({"tokens": torch.from_numpy(tokens)})
    jlogits, jcache = _strict_jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    assert logits.shape == jlogits.shape == (2, 1, cfg.vocab_size)
    assert logits.dtype == cfg.compute_dtype
    _held(logits, jlogits, dtype)
    assert sorted(cache) == sorted(jcache) == ["conv_B", "conv_C", "conv_x", "k", "state", "v"]
    assert cache["k"].shape == (nb, 2, PROMPT, 2, 32)
    assert cache["state"].shape == (nb, 7, 2, 16, 16, 16)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        assert cache[name].dtype == (torch.float32 if name == "state" else cfg.compute_dtype)
        _held(cache[name], jcache[name], dtype)

    decode = _strict_jit(jmodel.decode_step)
    pad = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4)) if k in ("k", "v") else v
           for k, v in cache.items()}
    jpad = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))) if k in ("k", "v") else v
            for k, v in jcache.items()}
    fresh = (model.init_cache(2, 12), jmodel.init_cache(2, 12), 0)
    for pc, jc, start in ((pad, jpad, PROMPT), fresh):
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        for pos in range(start, start + 3):
            lg, pc = model.decode_step({"token": torch.from_numpy(np.array(jtok)), "pos": pos,
                                        "cache": pc})
            jlg, jc = decode(jparams, {"token": jtok, "pos": jnp.asarray(pos, jnp.int32),
                                       "cache": jc})
            _held(lg, jlg, dtype)
            jtok = jnp.argmax(jlg, axis=-1).astype(jnp.int32)
        for name in pc:
            _held(pc[name], jc[name], dtype)


def test_decode_continues_prefill():
    """``tests/test_ssm.py::test_jamba_decode_continues_prefill`` on the
    port (float32 smoke): the last of 9 tokens decoded over the cache of
    the first 8's prefill (K/V padded by a row) gives the 9-token
    prefill's logits within the reference test's atol 0.08, rtol 0.05,
    and (measured here) within 1e-4 of their scale."""
    cfg, jcfg = _cfgs("f32")
    model, _, _ = _models(cfg, jcfg)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 9))
                            .astype(np.int32))
    lp_full, _ = model.prefill({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :-1]})
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) if k in ("k", "v") else v
             for k, v in cache.items()}
    ld, _ = model.decode_step({"token": toks[:, -1:], "pos": 8, "cache": cache})
    np.testing.assert_allclose(ld[:, 0].numpy(), lp_full[:, 0].numpy(), atol=0.08, rtol=0.05)
    _close(ld, lp_full, "f32")


def test_decode_clamps_an_out_of_range_position_like_xla():
    """At pos >= the cache length XLA's dynamic_update_slice writes the last
    K/V row; the port clamps the same way (float32), and the SSM state
    advances as at any position."""
    cfg, jcfg = _cfgs("f32")
    model, jmodel, jparams = _models(cfg, jcfg)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    warm = {name: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for name, (shape, _) in model.abstract_cache(2, 6).items()}
    pc = {k: torch.from_numpy(v.copy()) for k, v in warm.items()}
    jc = {k: jnp.asarray(v) for k, v in warm.items()}
    for pos in (6, 9):
        lg, pc = model.decode_step({"token": torch.from_numpy(tok), "pos": pos, "cache": pc})
        jlg, jc = _strict_jit(jmodel.decode_step)(jparams, {
            "token": jnp.asarray(tok), "pos": jnp.asarray(pos, jnp.int32), "cache": jc})
        _close(lg, jlg, "f32")
        for name in pc:
            _close(pc[name], jc[name], "f32")


# -- convert, smoke, serve ---------------------------------------------------------------


@pytest.mark.parametrize("blocks", sorted(BLOCKS))
def test_convert_round_trips(blocks):
    """The reference's bf16 tree (float32 norms, SSM scalars and router
    beside bf16 weights) loads with ``strict=True`` and crosses back byte
    for byte, path for path; the caches cross leaf by leaf."""
    cfg, jcfg = _cfgs("bf16", **BLOCKS[blocks])
    model, jmodel, jparams = _models(cfg, jcfg)
    model.load_state_dict(convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams)),
                          strict=True)
    back = convert.lm_params_to_numpy(model)
    jflat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    bflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in jflat] == [p for p, _ in bflat]
    for (path, a), (_, b) in zip(jflat, bflat):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    assert back["blocks"]["sub1"]["ffn"]["router"].dtype == np.float32
    assert back["blocks"]["sub0"]["mixer"]["A_log"].dtype == np.float32
    jcache = jax.tree.map(np.asarray, jmodel.init_cache(2, 4))
    cache = convert.lm_cache_from_numpy(jcache)
    assert sorted(cache) == sorted(jcache)
    want = model.abstract_cache(2, 4)
    for name, t in cache.items():
        assert (tuple(t.shape), t.dtype) == (jcache[name].shape, want[name][1])
        assert tuple(t.shape) == want[name][0]


def test_prefill_and_decode_smoke():
    """``tests/test_models_smoke.py::test_prefill_and_decode_smoke`` on
    the port: bf16 smoke weights drawn by the port's own ``init``, a
    32-token prefill and one decode step at pos 3 on a zero cache of 16:
    shapes, finite logits, the cache's entries kept."""
    cfg = configs.get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu").init(0)
    pre = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 32)).astype(np.int32))}
    logits, _ = model.prefill(pre)
    assert logits.shape == (1, 1, cfg.vocab_size) and torch.isfinite(logits.float()).all()
    cache = model.init_cache(1, 16)
    lg, new_cache = model.decode_step({"token": torch.ones((1, 1), dtype=torch.int32),
                                       "pos": 3, "cache": cache})
    assert lg.shape == (1, 1, cfg.vocab_size) and torch.isfinite(lg.float()).all()
    assert sorted(new_cache) == sorted(model.abstract_cache(1, 16))
    for name, (shape, dtype) in model.abstract_cache(1, 16).items():
        assert (tuple(new_cache[name].shape), new_cache[name].dtype) == (shape, dtype)


def test_full_config_matches_assignment():
    """``tests/test_models_smoke.py::test_full_config_matches_assignment``'s
    row for the arch, on the port's CONFIG."""
    cfg = configs.get_config(ARCH)
    for k, v in dict(num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, d_ff=24576,
                     vocab_size=65536).items():
        assert getattr(cfg, k) == v, k
    assert cfg.moe.num_experts == 16 and cfg.moe.top_k == 2
    assert (cfg.ssm.d_state, cfg.block_period, cfg.attn_index, cfg.moe_period) == (16, 8, 4, 2)
    assert cfg.sub_quadratic and not cfg.attention_free


def test_serve_main_smoke_cpu(capsys):
    rc = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "40", "--decode-steps", "4", "--cache-len", "16"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "arch=jamba-smoke prefill_s=" in out and "finite logits: True" in out
    assert len(out.split("sampled tokens[0]: [")[1].split("]")[0].split(",")) == 5
