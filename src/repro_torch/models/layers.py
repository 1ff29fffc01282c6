"""Shared building blocks of the LMs (the reference's ``repro.models.layers``).

Plain tensor functions over parameter tensors, with the reference's
numerics: norms, rotary embeddings and the SwiGLU gate in float32, cast
back to the activations' dtype; matrix products in the compute dtype
(``torch.matmul``, as the reference leaves them to XLA).
``chunked_softmax_xent`` is LM training's loss over sequence chunks;
under autograd each chunk runs inside ``torch.utils.checkpoint``, so the
backward keeps no chunk's (B, C, V) logits and recomputes them instead.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ModelConfig, ParamSpec


def rmsnorm_spec(dim: int) -> ParamSpec:
    return ParamSpec((dim,), torch.float32, "ones", logical=("embed",))


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
        "wi_gate": ParamSpec((d_model, d_ff), dtype, "scaled", logical=("embed", "mlp")),
        "wi_up": ParamSpec((d_model, d_ff), dtype, "scaled", logical=("embed", "mlp")),
        "wo": ParamSpec((d_ff, d_model), dtype, "scaled", logical=("mlp", "embed")),
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
    specs = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), cfg.param_dtype,
                              logical=("vocab", "embed"))}
    if not cfg.tie_embeddings:
        specs["out"] = ParamSpec((cfg.d_model, cfg.vocab_size), cfg.param_dtype, "scaled",
                                 logical=("embed", "vocab"))
    return specs


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The rows of ``tok`` (``F.embedding``: its backward sums a row's
    gradients in a fixed order on the CPU, where indexing's does not)."""
    return F.embedding(tokens.long(), _leaves(params)["tok"]).to(cfg.compute_dtype)


def output_logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    p = _leaves(params)
    w = p["tok"].T if cfg.tie_embeddings else p["out"]
    return x @ w.to(cfg.compute_dtype)


def chunked_softmax_xent(params, x: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over (B, S, d_model) activations without
    materializing the full (B, S, vocab) logits: a loop over sequence
    chunks of ``cfg.logit_chunk`` (one chunk of S when that does not
    divide S).  Each chunk's logits are computed in the compute dtype and
    cast to float32; the sum of ``mask``-weighted NLLs is divided by
    max(sum of the mask, 1)."""
    b, s, d = x.shape
    chunk = min(cfg.logit_chunk, s)
    if s % chunk:
        chunk = s  # fall back for odd smoke shapes
    p = _leaves(params)
    w = (p["tok"].T if cfg.tie_embeddings else p["out"]).to(cfg.compute_dtype)
    if mask is None:
        ms = torch.ones((b, s), dtype=torch.float32, device=x.device)
    else:
        ms = mask.to(torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, s, chunk):
        args = (x[:, c:c + chunk], labels[:, c:c + chunk], ms[:, c:c + chunk], w)
        if torch.is_grad_enabled():
            total = total + checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            total = total + _xent_chunk(*args)
    return total / torch.clamp(torch.sum(ms), min=1.0)


def _xent_chunk(xc: torch.Tensor, lc: torch.Tensor, mc: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """One chunk's sum of masked NLLs: (B, C, d) @ (d, V) -> float32 logits."""
    logits = (xc @ w).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return torch.sum((logz - gold) * mc)


def _leaves(params) -> Dict[str, Any]:
    """A module's direct parameters and submodules by name, or a dict as it is."""
    if isinstance(params, dict):
        return params
    out: Dict[str, Any] = dict(params.named_parameters(recurse=False))
    out.update(params.named_children())
    return out
