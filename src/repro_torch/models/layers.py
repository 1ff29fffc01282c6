"""Shared building blocks of the LMs (the reference's ``repro.models.layers``).

Plain tensor functions over parameter tensors, with the reference's
numerics: norms, rotary embeddings and the SwiGLU gate in float32, cast
back to the activations' dtype; matrix products in the compute dtype
(``torch.matmul``, as the reference leaves them to XLA).  The chunked
cross-entropy of LM training is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, ParamSpec


def rmsnorm_spec(dim: int) -> ParamSpec:
    return ParamSpec((dim,), torch.float32, "ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)       # a scalar base: no host-to-device copy


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  The
    split-halves form, in float32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)            # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs        # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                          # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_specs(d_model: int, d_ff: int, dtype) -> Dict[str, ParamSpec]:
    return {
        "wi_gate": ParamSpec((d_model, d_ff), dtype, "scaled"),
        "wi_up": ParamSpec((d_model, d_ff), dtype, "scaled"),
        "wo": ParamSpec((d_ff, d_model), dtype, "scaled"),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``silu(x @ wi_gate)`` in float32, cast to x's dtype, times
    ``x @ wi_up``, then ``@ wo``.  ``params`` is a module or a dict."""
    p = _leaves(params)
    gate = x @ p["wi_gate"]
    up = x @ p["wi_up"]
    hidden = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    return hidden @ p["wo"]


def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    specs = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), cfg.param_dtype)}
    if not cfg.tie_embeddings:
        specs["out"] = ParamSpec((cfg.d_model, cfg.vocab_size), cfg.param_dtype, "scaled")
    return specs


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _leaves(params)["tok"][tokens.long()].to(cfg.compute_dtype)


def output_logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    p = _leaves(params)
    w = p["tok"].T if cfg.tie_embeddings else p["out"]
    return x @ w.to(cfg.compute_dtype)


def _leaves(params) -> Dict[str, Any]:
    """A module's direct parameters and submodules by name, or a dict as it is."""
    if isinstance(params, dict):
        return params
    out: Dict[str, Any] = dict(params.named_parameters(recurse=False))
    out.update(params.named_children())
    return out
