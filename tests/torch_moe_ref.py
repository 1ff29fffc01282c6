"""Inputs and the reference side of ``tests/test_torch_moe.py``'s
expert-parallel tests.

``inputs()`` draws every input with numpy from fixed seeds (no JAX).  Run
as a script, in a process of its own with four virtual host devices,

    XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONPATH=src \\
        python tests/torch_moe_ref.py OUT.npz

it runs the reference's ``moe_forward_ep`` on meshes (1, 2), (1, 4) and
(2, 2) over ("data", "model") with Auto axes (``jax.make_mesh`` builds
Explicit axes by default) and writes y and aux of each to one npz (keys
``<mesh>/y``, ``<mesh>/aux``), with the one-device ``moe_forward`` as
``single/y`` and ``single/aux``.
"""
import math
import sys

import numpy as np

MESHES = ((1, 2), (1, 4), (2, 2))
B, S, D = 4, 8, 16
MOE = dict(num_experts=8, top_k=2, d_ff=32, num_shared_experts=1, shared_d_ff=24,
           capacity_factor=1.0)
CFG = dict(name="ep", family="moe", num_layers=1, d_model=D, num_heads=2, num_kv_heads=2,
           d_ff=32, vocab_size=64, head_dim=8)


def inputs():
    """One MoE FFN's float32 parameters (the reference's tree) and x (B, S,
    D); the router is scaled so that tokens contend for the experts and
    some are dropped at capacity factor 1."""
    rng = np.random.default_rng(21)
    e, f, sf = MOE["num_experts"], MOE["d_ff"], MOE["shared_d_ff"]

    def w(*shape):
        return (rng.standard_normal(shape) / math.sqrt(shape[-2])).astype(np.float32)

    params = {"router": 3 * w(D, e), "wi_gate": w(e, D, f), "wi_up": w(e, D, f),
              "wo": w(e, f, D),
              "shared": {"wi_gate": w(D, sf), "wi_up": w(D, sf), "wo": w(sf, D)}}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return params, x


def main(path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.models import moe as M
    from repro.models.common import ModelConfig, MoEConfig

    cfg = ModelConfig(**CFG, moe=MoEConfig(**MOE), param_dtype=jnp.float32,
                      compute_dtype=jnp.float32)
    params, x = inputs()
    jp = jax.tree.map(jnp.asarray, params)
    out = {}
    y, aux = M.moe_forward(jp, jnp.asarray(x), cfg)
    out["single/y"], out["single/aux"] = np.asarray(y), np.asarray(aux)
    for shape in MESHES:
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        y, aux = M.moe_forward_ep(jp, jnp.asarray(x), cfg, mesh, cfg.moe)
        out[f"{shape}/y"], out[f"{shape}/aux"] = np.asarray(y), np.asarray(aux)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
