"""GQA attention: blocked online-softmax prefill and decode over a KV cache.

A port of the GQA half of the reference's ``repro.models.attention``
(MLA waits for its slice).  ``blocked_attention`` is where the TPU
kernel's function runs: on a CUDA tensor it launches the hand-written
``flash_attention`` kernel through ``repro_torch.kernels.ops`` on the
(B, S, H, D) queries and (B, T, KVH, D) keys and values as (B, H, S, D)
views, read in place whatever the sequence length; on a CPU tensor it
runs the plain version, which keeps the reference's branch: the blocked
online softmax (``_flash_fwd_impl``) when the chunks divide S and T, the
dense softmax (``_dense_attention``) otherwise.  ``decode_attention`` is plain tensor
code on either device, as the reference computes it outside any kernel.

Masked scores are -2e38, not -inf, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, ParamSpec
from repro_torch.models.layers import apply_rope, rmsnorm

NEG_INF = -2.0e38


def gqa_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    specs = {
        "wq": ParamSpec((d, h, hd), dt, "scaled"),
        "wk": ParamSpec((d, kvh, hd), dt, "scaled"),
        "wv": ParamSpec((d, kvh, hd), dt, "scaled"),
        "wo": ParamSpec((h, hd, d), dt, "scaled"),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), dt, "zeros")
        specs["bk"] = ParamSpec((kvh, hd), dt, "zeros")
        specs["bv"] = ParamSpec((kvh, hd), dt, "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), torch.float32, "ones")
        specs["k_norm"] = ParamSpec((hd,), torch.float32, "ones")
    return specs


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, heads, hd) -> (B, S, heads, hd)."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd)).unflatten(-1, (heads, hd))


def gqa_project_qkv(params, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q (B, S, H, hd), k and v (B, S, KVH, hd): projection,
    bias, qk_norm, then rope on q and k."""
    q = _project(x, params.wq)
    k = _project(x, params.wk)
    v = _project(x, params.wv)
    if cfg.qkv_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    if cfg.qk_norm:
        q = rmsnorm(q, params.q_norm, cfg.rms_eps)
        k = rmsnorm(k, params.k_norm, cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def output_projection(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) @ (H, hd, d) -> (B, S, d)."""
    h, hd, d = wo.shape
    return o.flatten(-2) @ wo.reshape(h * hd, d)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, chunk: int = 1024,
                      k_chunk: Optional[int] = None,
                      softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KVH, D).  Returns (B, S, H, D)."""
    d = q.shape[3]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cuda":
        return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, scale=scale).transpose(1, 2)
    if q.device.type != "cpu":
        raise ValueError(f"no attention for device {q.device}; expected cpu or cuda")
    s, h = q.shape[1], q.shape[2]
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    cq = min(chunk, s)
    ck = min(k_chunk or chunk, t)
    if s % cq or t % ck:
        return _dense_attention(q, k, v, causal=causal, scale=scale)
    if g > 1:                                    # jnp.repeat: head h reads h // g
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return _flash_fwd_impl(q, k, v, causal, cq, ck, scale)


def _flash_fwd_impl(q, k, v, causal: bool, cq: int, ck: int, scale: float) -> torch.Tensor:
    """The reference's blocked forward: q blocks of cq rows, each over k
    blocks of ck rows with the online softmax carried in float32."""
    b, s, h, d = q.shape
    t = k.shape[1]
    nq, nk = s // cq, t // ck
    qb = q.reshape(b, nq, cq, h, d).permute(1, 0, 3, 2, 4)          # (nq,B,H,Cq,D)
    kb = k.reshape(b, nk, ck, h, d).permute(1, 0, 3, 2, 4)          # (nk,B,H,Ck,D)
    vb = v.reshape(b, nk, ck, h, d).permute(1, 0, 3, 2, 4)
    q_pos = torch.arange(cq, device=q.device)
    k_pos = torch.arange(ck, device=q.device)
    outs = []
    for qi in range(nq):
        qc = qb[qi]
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, cq, d), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            kc, vc = kb[kj], vb[kj]
            sc = torch.einsum("bhqd,bhkd->bhqk", qc, kc).to(torch.float32) * scale
            if causal:
                mask = (qi * cq + q_pos)[:, None] >= (kj * ck + k_pos)[None, :]
                sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(qc.dtype), vc).to(torch.float32)
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, d)


def _dense_attention(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, d)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(torch.float32) * scale
    if causal:
        mask = torch.arange(s, device=q.device)[:, None] >= torch.arange(t, device=q.device)[None, :]
        sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, s, h, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos, softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, 1, H, D) over a (B, S, KVH, D) cache whose positions <= pos
    are valid -> (B, 1, H, D)."""
    b, _, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, kvh, g, d)
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).to(torch.float32) * scale
    valid = torch.arange(s, device=q.device)[None, None, None, :] <= pos
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache)
    return out.reshape(b, 1, h, d)
