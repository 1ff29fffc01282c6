"""Inputs and the reference side of ``tests/test_torch_steps_sharded.py``.

``draw_params``, ``batches``, ``serve_inputs`` and ``ep_cotangent`` draw
every input with numpy from fixed seeds (no JAX).  Run as a script, in a process of its own with four virtual host devices,

    XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src \\
        python tests/torch_steps_ref.py OUT.npz

it runs the reference's ``make_train_step`` for ``deepseek-smoke`` (8
experts, ``moe_forward_ep`` on a "model" axis above 1) and
``qwen3-smoke``, float32, on meshes (2, 2) and (1, 4) over ("data",
"model") with Auto axes (``jax.make_mesh`` builds Explicit axes by
default), ``STEPS`` steps each, and writes each step's loss and grad
norm and the parameters after each step (``<arch>/<mesh>/...``).  For
deepseek on (2, 2) it also writes each data shard's MoE aux loss before
each step (``aux``), computed on one device: the reference's reported
loss on a data axis above 1 carries the first shard's.  It then runs
``make_prefill_step`` and ``make_decode_step`` for deepseek on (2, 2)
(``serve/...``) and ``jax.grad`` through ``moe_forward_ep`` on both
meshes (``ep/<mesh>/...``), on ``tests/torch_moe_ref.py``'s inputs.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_moe_ref as MR  # noqa: E402

ARCHS = ("deepseek-v2-236b", "qwen3-8b")
MESHES = ((2, 2), (1, 4))
B, S = 4, 32
STEPS = 2
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=100)
DECODE_EXTRA = 8          # cache positions past the prompt for the decode step
AUX_COEF = 0.5            # the EP backward's loss: sum(y * cot) + AUX_COEF * aux
STD, STD_ROUTER = 0.05, 0.3


def smoke(get_smoke_config, arch, f32):
    """The SMOKE config in float32; deepseek with remat on, so the
    expert-parallel forward is recomputed inside the backward."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, param_dtype=f32, compute_dtype=f32)
    if cfg.moe is not None:
        assert cfg.moe.num_experts == 8
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


def draw_params(abstract, seed):
    """A numpy leaf for every (nested) leaf of ``abstract``: the norms'
    scales 1 + N(0, 0.1), the routers N(0, STD_ROUTER) (logits of a few
    units: tokens contend for the experts and the top-k margins stay
    clear of rounding), every other matrix N(0, STD)."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if len(shape) == 1 or name.endswith("norm") or name.startswith("ln"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        std = STD_ROUTER if name == "router" else STD
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, tuple(v.shape))
                for k, v in sorted(tree.items())}

    return walk(abstract)


def batches(vocab, seed):
    """``STEPS`` batches of (B, S) tokens and next-token labels."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (STEPS, B, S + 1)).astype(np.int32)
    return [{"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()} for t in toks]


def serve_inputs(vocab):
    rng = np.random.default_rng(31)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "token": rng.integers(0, vocab, (B, 1)).astype(np.int32)}


def ep_cotangent():
    return np.random.default_rng(41).standard_normal((MR.B, MR.S, MR.D)).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def main(path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro import configs as cfglib
    from repro.launch.steps import make_decode_step, make_prefill_step, make_train_step
    from repro.models import build_model
    from repro.models import moe as M
    from repro.models.common import ModelConfig, MoEConfig
    from repro.optim import OptimizerConfig

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])

    out = {}
    for arch in ARCHS:
        cfg = smoke(cfglib.get_smoke_config, arch, jnp.float32)
        model = build_model(cfg)
        params0 = draw_params(model.abstract(), 11)
        data = batches(cfg.vocab_size, 13)
        backbone = jax.jit(lambda p, b: model.backbone(
            p, model.embed_inputs(p, b),
            jnp.broadcast_to(jnp.arange(S), b["tokens"].shape))[1])
        for shape in MESHES:
            tag = f"{arch}/{shape}"
            bundle = make_train_step(cfg, mesh_of(shape), B, S, opt_cfg=OptimizerConfig(**OPT))
            step = bundle.jit()
            p = jax.device_put(params0, bundle.in_shardings[0])
            o = jax.device_put(jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                            bundle.abstract_args[1]), bundle.in_shardings[1])
            losses, norms, aux = [], [], []
            for i, b in enumerate(data):
                if cfg.moe is not None and shape[0] > 1:
                    host = jax.tree.map(np.asarray, p)
                    aux.append([float(backbone(host, {k: v[d * B // shape[0]:(d + 1) * B
                                                          // shape[0]] for k, v in b.items()}))
                                for d in range(shape[0])])
                p, o, m = step(p, o, jax.device_put(b, bundle.in_shardings[2]))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                for k, v in _flat(jax.tree.map(np.asarray, p)).items():
                    out[f"{tag}/step{i + 1}/{k}"] = v
            out[f"{tag}/loss"] = np.array(losses)
            out[f"{tag}/grad_norm"] = np.array(norms)
            if aux:
                out[f"{tag}/aux"] = np.array(aux)

    # prefill and decode for deepseek on (2, 2)
    cfg = smoke(cfglib.get_smoke_config, ARCHS[0], jnp.float32)
    params0 = draw_params(build_model(cfg).abstract(), 11)
    ins = serve_inputs(cfg.vocab_size)
    mesh = mesh_of((2, 2))
    pre = make_prefill_step(cfg, mesh, B, S)
    logits, cache = pre.jit()(jax.device_put(params0, pre.in_shardings[0]),
                              jax.device_put({"tokens": ins["tokens"]}, pre.in_shardings[1]))
    out["serve/prefill_logits"] = np.asarray(logits)
    for k, v in cache.items():
        out[f"serve/prefill_cache/{k}"] = np.asarray(v)
    dec = make_decode_step(cfg, mesh, B, S + DECODE_EXTRA)
    long = {k: np.concatenate([np.asarray(v), np.zeros(v.shape[:2] + (DECODE_EXTRA,)
                                                       + v.shape[3:], np.float32)], axis=2)
            for k, v in cache.items()}
    logits, cache = dec.jit()(jax.device_put(params0, dec.in_shardings[0]), jax.device_put(
        {"token": ins["token"], "pos": np.int32(S), "cache": long}, dec.in_shardings[1]))
    out["serve/decode_logits"] = np.asarray(logits)
    for k, v in cache.items():
        out[f"serve/decode_cache/{k}"] = np.asarray(v)

    # the expert-parallel forward's backward
    mcfg = ModelConfig(**MR.CFG, moe=MoEConfig(**MR.MOE), param_dtype=jnp.float32,
                       compute_dtype=jnp.float32)
    eparams, x = MR.inputs()
    cot = ep_cotangent()
    for shape in MESHES:
        mesh = mesh_of(shape)

        def loss(p, xx):
            y, a = M.moe_forward_ep(p, xx, mcfg, mesh, mcfg.moe)
            return jnp.sum(y * cot) + AUX_COEF * a

        g_p, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jax.tree.map(jnp.asarray, eparams), jnp.asarray(x))
        for k, v in _flat(jax.tree.map(np.asarray, g_p)).items():
            out[f"ep/{shape}/{k}"] = v
        out[f"ep/{shape}/x"] = np.asarray(g_x)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
