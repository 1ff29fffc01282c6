"""Model configuration and parameter-spec machinery of the LM families.

A port of the reference's ``repro.models.common``: the config dataclasses
with torch dtypes in place of ``jnp`` dtypes, and ``ParamSpec`` trees
(shape, dtype, initializer) from which a model builds its parameters.
The reference's logical axes and ``partition_specs`` are left out: the
port has no sharded LM yet.

Initializers are the reference's (``_init_leaf``): ``zeros``, ``ones``,
``scaled`` (normal with std ``scale / sqrt(shape[0])``, drawn in float32
and cast) and ``normal`` (std ``0.02 * scale``).  The reference draws
each leaf of its tree whole, and the layers' leaves are stacked on a
leading layer axis, so their ``shape[0]`` -- the fan-in of "scaled" -- is
the number of layers; ``stacked`` keeps that, and the port draws a
stacked leaf one layer at a time with the stacked leaf's std.  JAX's PRNG
cannot be matched: tests carry weights across with ``repro_torch.convert``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden
    num_shared_experts: int = 0
    shared_d_ff: int = 0            # hidden of the fused shared-expert MLP
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm | hybrid | moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    # hybrid (Jamba): blocks of ``block_period`` layers with one attention
    # layer at ``attn_index``; every ``moe_period``-th FFN is MoE
    block_period: int = 0
    attn_index: int = 0
    moe_period: int = 0
    encoder_layers: int = 0         # >0 selects the enc-dec model family
    frontend: Optional[str] = None  # None | "vision" | "audio"
    num_patches: int = 0            # vision tokens prepended per sample
    # numerics
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    # attention lowering
    attn_chunk: int = 1024          # online-softmax q-block size
    attn_k_chunk: int = 4096        # kv-block size
    remat: bool = True
    logit_chunk: int = 1024         # chunked cross-entropy block
    sharding_profile: str = "tp"    # "tp" (Megatron-style) | "fsdp"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"            # normal | zeros | ones | scaled
    scale: float = 1.0


def stacked(spec: ParamSpec, n: int) -> ParamSpec:
    """Add a leading layer ("stack") dimension, as the reference does."""
    return dataclasses.replace(spec, shape=(n,) + spec.shape)


@torch.no_grad()
def init_leaf(out: torch.Tensor, spec: ParamSpec, gen: torch.Generator) -> None:
    """Fill ``out`` (of ``spec.shape``, or one layer of a stacked spec) by
    ``spec``'s initializer, drawing float32 on ``out``'s device."""
    if spec.init == "zeros":
        out.zero_()
        return
    if spec.init == "ones":
        out.fill_(1)
        return
    if spec.init == "scaled":
        fan_in = spec.shape[0] if spec.shape else 1
        std = spec.scale / math.sqrt(max(fan_in, 1))
    else:                                          # "normal"
        std = 0.02 * spec.scale
    draw = torch.randn(out.shape, generator=gen, dtype=torch.float32, device=out.device)
    out.copy_(draw.mul_(std))


def module_from_specs(specs: Dict[str, Any], device: torch.device) -> nn.Module:
    """An ``nn.Module`` holding one uninitialized parameter per spec leaf,
    nested dicts becoming submodules of the same names."""
    m = nn.Module()
    for key, spec in specs.items():
        if isinstance(spec, dict):
            m.add_module(key, module_from_specs(spec, device))
        else:
            m.register_parameter(key, nn.Parameter(
                torch.empty(spec.shape, dtype=spec.dtype, device=device)))
    return m
