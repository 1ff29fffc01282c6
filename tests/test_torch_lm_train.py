"""The port's LM training slice against the reference: the chunked
cross-entropy, the attention's custom VJP (``_Flash`` against the
reference's ``_flash``), ``DecoderLM.loss`` and its gradients for the
dense, MoE, MLA and vision configs, remat, the ``Trainer``'s LM path fed
by ``lm_batches_from_table``, LM checkpoints crossing between the
packages, the train CLI and ``examples/torch/lm_data_pipeline.py``.

Smoke widths, with ``attn_chunk``, ``attn_k_chunk`` and ``logit_chunk``
32 at seq 128, so the blocked attention and the cross-entropy loop over
several blocks and chunks.  The reference's weights come across with
``convert.lm_params_from_numpy``.  float32 differs only by the order of
sums; bf16 is held against the reference compiled without excess
precision (``test_torch_ssm._strict_jit``) in relative norm, with the
gaps stated where the tolerances are set.
"""
import dataclasses
import runpy
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import tokens as JT  # noqa: E402
from repro.core.warehouse import Warehouse as JWarehouse  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.common import MLAConfig as JMLAConfig  # noqa: E402
from repro.models.common import MoEConfig as JMoEConfig  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import tokens as T  # noqa: E402
from repro_torch.core.warehouse import Warehouse  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention, build_model, layers  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.common import MLAConfig, MoEConfig  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_init  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

from test_torch_ssm import _strict_jit  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CHUNKS = dict(attn_chunk=32, attn_k_chunk=32, logit_chunk=32)
SEQ, BATCH = 128, 2
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
TIE_MARGIN = 1e-5             # test_torch_moe.py's: no top-k margin in the data below it
# float32: sums in another order
F32_LOSS_RTOL, F32_GRAD_TOL = 1e-5, 1e-4
# _Flash against the reference's _flash: float32 1e-5 of the value scale;
# bf16 2e-2, the reference kernel sweep's bf16 bound (tests/test_kernels.py)
FLASH_TOL = {"f32": 1e-5, "bf16": 2e-2}
# the model in bf16 against the reference compiled strictly, in relative
# norm: the loss (measured gaps 1.5e-6 to 2.0e-5) and each gradient leaf
# (worst measured 8.1e-3 to 1.17e-2: embed.tok, whose rows sum many bf16
# products, and MLA's q_norm)
BF16_LOSS_RTOL, BF16_GRAD_TOL = 1e-3, 3e-2

SMOKE = dataclasses.replace(configs.get_smoke_config("qwen3-8b"), **CHUNKS)
J_SMOKE = dataclasses.replace(jconfigs.get_smoke_config("qwen3-8b"), **CHUNKS)
FAMILIES = {
    "dense": ({}, {}),
    "moe": (dict(moe=MoEConfig(num_experts=4, top_k=2, d_ff=64)),
            dict(moe=JMoEConfig(num_experts=4, top_k=2, d_ff=64))),
    "mla": (dict(mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                               qk_rope_dim=8, v_head_dim=16)),
            dict(mla=JMLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                                qk_rope_dim=8, v_head_dim=16))),
    "vision": (dict(frontend="vision", num_patches=16),
               dict(frontend="vision", num_patches=16)),
}


def _cfgs(family: str, dtype: str, **change):
    td, jd = DTYPES[dtype]
    t, j = FAMILIES[family]
    cfg = dataclasses.replace(SMOKE, **t, param_dtype=td, compute_dtype=td, **change)
    jcfg = dataclasses.replace(J_SMOKE, **j, param_dtype=jd, compute_dtype=jd, **change)
    return cfg, jcfg


# the reference's init takes a stack's length (2 layers) as the router's
# fan-in: its softmax saturates (top-1 ~0.89) and the 2nd and 3rd
# probabilities meet within 1e-9, a tie either package may break; both
# packages' routers are scaled by this (top-1 ~0.45, margins 4e-5 and up)
ROUTER_SCALE = 0.1


def _models(cfg, jcfg, seed=0):
    """The reference model and its initial parameters (numpy leaves; a
    MoE's router scaled by ROUTER_SCALE), and the port's model holding
    them."""
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    if cfg.moe:
        ffn = jparams["layers"]["ffn"]
        ffn["router"] = (ffn["router"] * ROUTER_SCALE).astype(ffn["router"].dtype)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_numpy(jparams))
    return model, jmodel, jparams


def _batch(cfg, seed=0, seq=SEQ, batch=BATCH):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.frontend == "vision":
        out["image_embeds"] = rng.normal(0, 0.02, (batch, cfg.num_patches, cfg.d_model)
                                         ).astype(np.float32)
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _rel(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _grads(model, batch):
    names = sorted(n for n, _ in model.named_parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model.loss(tb)
    grads = torch.autograd.grad(loss, [model.get_parameter(n) for n in names])
    return loss.detach(), dict(zip(names, grads))


# -- chunked cross-entropy ------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [32, 48])       # 48 does not divide 128: one chunk
def test_chunked_softmax_xent_matches_reference(masked, chunk):
    cfg, jcfg = _cfgs("dense", "f32", logit_chunk=chunk)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((cfg.d_model, cfg.vocab_size)) * 0.1).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    mask = (rng.random((BATCH, SEQ)) > 0.3).astype(np.float32) if masked else None
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    got = layers.chunked_softmax_xent({"out": tw}, tx,
                                      torch.from_numpy(labels), cfg, tmask)
    gx, gw = torch.autograd.grad(got, [tx, tw])

    def ref(x_, w_):
        jmask = None if mask is None else jnp.asarray(mask)
        return jlayers.chunked_softmax_xent({"out": w_}, x_, jnp.asarray(labels), jcfg, jmask)

    want, (jgx, jgw) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=F32_LOSS_RTOL)
    assert _rel(gx, jgx) < F32_GRAD_TOL and _rel(gw, jgw) < F32_GRAD_TOL


def test_chunked_softmax_xent_keeps_no_chunk_logits():
    """Under autograd each chunk is checkpointed: the graph holds the
    chunk's inputs, not its (B, C, V) float32 logits."""
    cfg, _ = _cfgs("dense", "f32")
    x = torch.randn((BATCH, SEQ, cfg.d_model), requires_grad=True)
    w = torch.randn((cfg.d_model, cfg.vocab_size), requires_grad=True)
    labels = torch.randint(0, cfg.vocab_size, (BATCH, SEQ))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = layers.chunked_softmax_xent({"out": w}, x, labels, cfg)
    loss.backward()
    assert saved and all(cfg.vocab_size not in s or len(s) < 3 for s in saved), saved


# -- the attention's custom VJP ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_vjp_matches_reference(dtype, heads, kv_heads, causal):
    """``blocked_attention`` under autograd (``_Flash`` after the GQA
    repeat) against the reference's (``_flash``'s custom VJP, compiled
    strictly): the output, the LSE of ``_flash_fwd_impl`` and dq, dk, dv
    by ``jax.vjp``, in relative norm within FLASH_TOL.  bf16 gaps
    measured: at most 7e-3 of the value scale; by the largest element
    the GQA groups' bf16 sums differ by up to 5.6e-2 of the rms, as each
    package's bf16 result sits from a float64 run (3e-2 to 9e-2)."""
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(2)
    d, s = 32, SEQ
    arrays = [rng.standard_normal((BATCH, s, n, d)).astype(np.float32)
              for n in (heads, kv_heads, kv_heads)]
    dout = rng.standard_normal((BATCH, s, heads, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(td).requires_grad_() for a in arrays)
    out = attention.blocked_attention(tq, tk, tv, causal=causal, chunk=32, k_chunk=16)
    assert type(out.grad_fn).__name__ == "_FlashBackward"
    got = torch.autograd.grad(out, [tq, tk, tv], torch.from_numpy(dout).to(td))

    def ref(q, k, v, do):
        o, vjp = jax.vjp(lambda *a: jattn.blocked_attention(*a, causal=causal, chunk=32,
                                                            k_chunk=16), q, k, v)
        return (o, *vjp(do))

    jargs = [jnp.asarray(a, jd) for a in arrays]
    want = _strict_jit(ref)(*jargs, jnp.asarray(dout, jd))
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out, *got), want):
        assert g.dtype == td and g.shape == w.shape, name
        assert _rel(g, w) < FLASH_TOL[dtype], (name, _rel(g, w))
    # the LSE the backward reads: the GQA-repeated operands, as _Flash sees them
    g_ = heads // kv_heads
    rep = [torch.from_numpy(a).to(td).repeat_interleave(g_, dim=2) for a in arrays[1:]]
    _, lse = attention._flash_fwd_impl(tq.detach(), *rep, causal, 32, 16, 1 / np.sqrt(d))
    _, jlse = _strict_jit(lambda *a: jattn._flash_fwd_impl(*a, causal, 32, 16, 1 / np.sqrt(d)))(
        jargs[0], *(jnp.repeat(a, g_, axis=2) for a in jargs[1:]))
    assert lse.dtype == torch.float32 and lse.shape == (BATCH, heads, s)
    assert _rel(lse, jlse) < FLASH_TOL[dtype], _rel(lse, jlse)


def test_blocked_attention_routes():
    """Without grad: the plain blocked forward (no graph); under grad: the
    dense softmax when the chunks do not divide, ``_Flash`` otherwise."""
    q = torch.randn((1, 64, 2, 16))
    with torch.no_grad():
        assert attention.blocked_attention(q, q, q, chunk=32).grad_fn is None
    q.requires_grad_()
    assert attention.blocked_attention(q, q, q, chunk=32).grad_fn is not None
    assert type(attention.blocked_attention(q, q, q, chunk=32).grad_fn).__name__ == \
        "_FlashBackward"
    assert type(attention.blocked_attention(q, q, q, chunk=48).grad_fn).__name__ != \
        "_FlashBackward"
    with torch.no_grad():
        assert attention.blocked_attention(q, q, q, chunk=32).grad_fn is None


# -- DecoderLM.loss -------------------------------------------------------------------


def _route_margins(monkeypatch, seen):
    """Record every port ``route`` call's smallest top-k margin."""
    route = moe_lib.route

    def recording(router_w, x, m):
        p = torch.softmax(x.detach().to(m.router_dtype) @ router_w.detach(), dim=-1)
        top = torch.topk(p, m.top_k + 1, dim=-1).values
        seen.append(float((top[:, m.top_k - 1] - top[:, m.top_k]).min()))
        return route(router_w, x, m)

    monkeypatch.setattr(moe_lib, "route", recording)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_decoder_loss_and_grads_match_reference(family, dtype, monkeypatch):
    """``DecoderLM.loss`` and every gradient against the reference's
    ``jax.value_and_grad(loss)``: float32 loss rtol 1e-5, gradients 1e-4
    in relative norm; bf16 against the reference compiled strictly."""
    cfg, jcfg = _cfgs(family, dtype)
    model, jmodel, jparams = _models(cfg, jcfg)
    batch = _batch(cfg)
    margins = []
    if family == "moe":
        _route_margins(monkeypatch, margins)
    loss, grads = _grads(model, batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.value_and_grad(jmodel.loss)
    if dtype == "bf16":
        fn = _strict_jit(fn)
    jloss, jgrads = fn(jax.tree.map(jnp.asarray, jparams), jbatch)
    want = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jgrads))
    assert sorted(grads) == sorted(want)
    if family == "moe":
        assert len(margins) == cfg.num_layers and min(margins) > TIE_MARGIN, margins
    gaps = {n: _rel(g, want[n]) for n, g in grads.items()}
    worst = max(gaps, key=gaps.get)
    if dtype == "f32":
        np.testing.assert_allclose(float(loss), float(jloss), rtol=F32_LOSS_RTOL)
        assert gaps[worst] < F32_GRAD_TOL, (worst, gaps[worst])
    else:
        print(f"{family} bf16: loss gap {abs(float(loss) / float(jloss) - 1):.3e}, "
              f"worst gradient {worst} {gaps[worst]:.3e}")
        np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_LOSS_RTOL)
        assert gaps[worst] < BF16_GRAD_TOL, (worst, gaps[worst])
    for n, g in grads.items():
        assert g.dtype == model.get_parameter(n).dtype and torch.isfinite(g).all(), n


def test_vision_loss_masks_the_patch_positions():
    """The vision loss is the cross-entropy of the positions after
    ``num_patches`` alone: labels under the patches do not move it."""
    cfg, _ = _cfgs("vision", "f32")
    model, _, _ = _models(cfg, _cfgs("vision", "f32")[1])
    batch = _batch(cfg)
    other = dict(batch, labels=batch["labels"].copy())
    other["labels"][:, :cfg.num_patches] = (other["labels"][:, :cfg.num_patches] + 1) % 7
    with torch.no_grad():
        a = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        b = model.loss({k: torch.from_numpy(v) for k, v in other.items()})
    assert torch.equal(a, b)


def test_remat_gives_bit_equal_gradients():
    cfg, jcfg = _cfgs("dense", "f32")
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


# -- the Trainer ----------------------------------------------------------------------

TRAIN_OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=6)


def _corpus_batches(cfg, package):
    tokens, wh = (T, Warehouse) if package == "port" else (JT, JWarehouse)
    table = tokens.build_corpus(wh(), n_partitions=2, docs_per_partition=24,
                                vocab_size=cfg.vocab_size, seed=0)
    return list(tokens.lm_batches_from_table(table, seq_len=SEQ, batch_size=BATCH))


def _port_state(jstate, opt_cfg):
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jstate["params"]))
    return {"params": params, "opt": adamw_init(params, opt_cfg), "step": 0}


def test_trainer_fit_matches_reference():
    """Six ``Trainer.fit`` steps fed by ``lm_batches_from_table`` from the
    reference's initial state: losses within 1e-4 of the reference's."""
    cfg, jcfg = _cfgs("dense", "f32")
    batches = _corpus_batches(cfg, "port")
    jbatches = _corpus_batches(jcfg, "reference")
    assert len(batches) >= 6
    jtrainer = JTrainer(jcfg, JOptimizerConfig(**TRAIN_OPT), JTrainerConfig(max_steps=6))
    jstate = jtrainer.init_state(0)
    trainer = Trainer(cfg, OptimizerConfig(**TRAIN_OPT), TrainerConfig(max_steps=6),
                      device="cpu")
    state = trainer.fit(iter(batches), _port_state(jstate, trainer.opt_cfg))
    jtrainer.fit(iter(jbatches), jstate)
    assert state["step"] == 6
    got = [m.loss for m in trainer.history]
    want = [m.loss for m in jtrainer.history]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    # the first step's gradients are of the same weights; after it AdamW's
    # g / (|g| + eps) turns the float32 noise of gradients near 0 into
    # updates of the learning rate's size, and the norms part by ~1e-3
    norms = [m.grad_norm for m in trainer.history]
    jnorms = [m.grad_norm for m in jtrainer.history]
    assert norms[0] == pytest.approx(jnorms[0], rel=1e-4)
    assert norms == pytest.approx(jnorms, rel=1e-2)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_lm_checkpoint_crosses_packages(writer):
    """One package trains 3 steps and saves; the other restores it and
    trains 3 more, within 1e-4 of the writer continuing itself."""
    cfg, jcfg = _cfgs("dense", "f32")
    batches = _corpus_batches(cfg, "port")[:6]
    jbatches = _corpus_batches(jcfg, "reference")[:6]
    opt, jopt = OptimizerConfig(**TRAIN_OPT), JOptimizerConfig(**TRAIN_OPT)

    def jstate0():          # anew for each fit: the reference's step donates its state
        return JTrainer(jcfg, jopt, JTrainerConfig(max_steps=1)).init_state(0)

    def port(d, steps, feed, fresh):
        t = Trainer(cfg, opt, TrainerConfig(checkpoint_dir=d, max_steps=steps,
                                            checkpoint_every=3), device="cpu")
        t.fit(iter(feed), _port_state(jstate0(), opt) if fresh else None)
        return [m.loss for m in t.history]

    def ref(d, steps, feed, fresh):
        t = JTrainer(jcfg, jopt, JTrainerConfig(checkpoint_dir=d, max_steps=steps,
                                               checkpoint_every=3))
        t.fit(iter(feed), jstate0() if fresh else None)
        return [m.loss for m in t.history]

    write, read = (port, ref) if writer == "port" else (ref, port)
    wfeed, rfeed = (batches, jbatches) if writer == "port" else (jbatches, batches)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        write(a, 3, wfeed[:3], True)
        write(b, 3, wfeed[:3], True)
        resumed = read(a, 6, rfeed[3:], False)
        itself = write(b, 6, wfeed[3:], False)
    assert len(resumed) == len(itself) == 3
    np.testing.assert_allclose(resumed, itself, rtol=1e-4)


def test_lm_checkpoint_tree_is_the_reference_layout():
    """The LM checkpoint tree stacks each layer leaf on axis 0, for the
    parameters and both moments, as the reference's tree holds them."""
    cfg, jcfg = _cfgs("dense", "f32")
    model, _, jparams = _models(cfg, jcfg)
    params = {n: p.detach() for n, p in sorted(model.named_parameters())}
    tree = Trainer.checkpoint_tree(params, adamw_init(params, OptimizerConfig()))
    want = convert.flatten(jparams)
    for part in (tree["params"], tree["opt"]["mu"], tree["opt"]["nu"]):
        flat = convert.flatten(part)
        assert sorted(flat) == sorted(want)
        for n, leaf in flat.items():
            assert tuple(leaf.shape) == want[n].shape, n
    for n, leaf in convert.flatten(tree["params"]).items():
        np.testing.assert_array_equal(_np(leaf), np.asarray(want[n], np.float32))


# -- the CLI and the example ----------------------------------------------------------


def test_train_cli_trains_an_lm_smoke(capsys):
    assert train_cli.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                           "--steps", "12", "--batch-size", "8"]) == 0
    out = capsys.readouterr().out
    assert "arch=qwen3-smoke device=cpu steps=12" in out


def test_train_cli_lm_archs():
    """``--arch`` takes every arch, and no other."""
    assert train_cli.TRAIN_ARCHS == configs.ARCH_IDS
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "no-such-arch", "--smoke", "--device", "cpu"])


def test_lm_synthetic_batches_match_reference():
    from repro.launch.train import lm_synthetic_batches as j_batches

    for arch in ("qwen3-8b", "llava-next-mistral-7b", "seamless-m4t-large-v2"):
        cfg = configs.get_smoke_config(arch)
        jcfg = jconfigs.get_smoke_config(arch)
        got, want = train_cli.lm_synthetic_batches(cfg, 3, 32), j_batches(jcfg, 3, 32)
        for _ in range(2):
            g, w = next(got), next(want)
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_lm_data_pipeline_example_runs_on_cpu():
    main = runpy.run_path(str(ROOT / "examples" / "torch" / "lm_data_pipeline.py"))["main"]
    assert main(["--device", "cpu"]) == 0
