"""Attention: GQA (blocked online-softmax prefill, decode over a KV cache)
and MLA.

A port of the reference's ``repro.models.attention``.  ``blocked_attention`` is where the TPU
kernel's function runs: on a CUDA tensor it launches the hand-written
``flash_attention`` kernel through ``repro_torch.kernels.ops`` on the
(B, S, H, D) queries and (B, T, KVH, D) keys and values as (B, H, S, D)
views, read in place whatever the sequence length; on a CPU tensor it
runs the plain version, which keeps the reference's branch: the blocked
online softmax (``_flash_fwd_impl``) when the chunks divide S and T, the
dense softmax (``_dense_attention``) otherwise.  ``decode_attention`` is plain tensor
code on either device, as the reference computes it outside any kernel.

Training differentiates through attention, and the CUDA kernels are
forward-only (they return no log-sum-exp).  So when grad is enabled and
an operand requires it, ``blocked_attention`` takes the reference's
training routes on either device, decided from the operands before any
launch: ``_dense_attention`` when the chunks do not divide, else
``_Flash``, the reference's custom VJP (``_flash``) as a
``torch.autograd.Function``: the blocked forward saving the LSE, and
``_flash_bwd``'s blocked recompute backward, with ``p`` and ``ds``
rounded to the operand dtype before their products and the row sums
``delta`` in float32.  GQA's K/V are repeated to every query head before
it, so autograd sums a group's gradients, as in the reference.
``_Flash``'s forward is an ``attention.fwd`` span of the ``tracer``
``blocked_attention`` is given (a remat's recompute records one too) and
its backward an ``attention.bwd`` span; the tracer rides on autograd's
``ctx``, since the backward may run on autograd's device thread, which
sees none of the forward's context.

MLA (DeepSeek-V2's multi-head latent attention) caches the compressed
``c_kv`` (B, S, kv_lora) and the shared rope key ``k_rope`` (B, S,
rope).  Its prefill expands them to per-head keys and values, puts the
rope part beside the nope part (qk dim 128 + 64 = 192 at full width),
pads v to that dim and calls ``blocked_attention`` with the scale
1/sqrt(qk dim), so on the card the flash kernel runs at D = 192 (its FMA
route), and slices the output back to ``v_head_dim``.  Its decode is the
absorbed-matrix form in plain tensor code, as in the reference.

Masked scores are -2e38, not -inf, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, ParamSpec
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.obs import NULL_TRACER

NEG_INF = -2.0e38


def gqa_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    specs = {
        "wq": ParamSpec((d, h, hd), dt, "scaled", logical=("embed", "heads", None)),
        "wk": ParamSpec((d, kvh, hd), dt, "scaled", logical=("embed", "kv_heads", None)),
        "wv": ParamSpec((d, kvh, hd), dt, "scaled", logical=("embed", "kv_heads", None)),
        "wo": ParamSpec((h, hd, d), dt, "scaled", logical=("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), dt, "zeros", logical=("heads", None))
        specs["bk"] = ParamSpec((kvh, hd), dt, "zeros", logical=("kv_heads", None))
        specs["bv"] = ParamSpec((kvh, hd), dt, "zeros", logical=("kv_heads", None))
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), torch.float32, "ones", logical=(None,))
        specs["k_norm"] = ParamSpec((hd,), torch.float32, "ones", logical=(None,))
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
                      softmax_scale: Optional[float] = None,
                      tracer=NULL_TRACER) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KVH, D).  Returns (B, S, H, D).
    ``tracer`` records ``_Flash``'s spans on the training route."""
    d = q.shape[3]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no attention for device {q.device}; expected cpu, cuda or meta")
    train = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    if q.device.type != "cpu" and not train:       # meta: routed as cuda (launch.dryrun)
        return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, scale=scale).transpose(1, 2)
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
    if train:
        return _Flash.apply(q, k, v, causal, cq, ck, scale, tracer)
    return _flash_fwd_impl(q, k, v, causal, cq, ck, scale)[0]


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP over (B, S, H, D) q and k, v
    of as many heads: forward ``_flash_fwd_impl`` (an ``attention.fwd``
    span), backward ``_flash_bwd`` (``attention.bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, cq: int, ck: int, scale: float,
                tracer=NULL_TRACER):
        with tracer.span("attention.fwd"):
            out, lse = _flash_fwd_impl(q, k, v, causal, cq, ck, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, cq, ck, scale)
        ctx.tracer = tracer
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with ctx.tracer.span("attention.bwd"):
            dq, dk, dv = _flash_bwd(*ctx.blocks, q, k, v, out, lse, dout)
        return dq, dk, dv, None, None, None, None, None


def _flash_fwd_impl(q, k, v, causal: bool, cq: int, ck: int,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's blocked forward: q blocks of cq rows, each over k
    blocks of ck rows with the online softmax carried in float32.
    Returns the output (B, S, H, D) and the float32 LSE (B, H, S)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    nq, nk = s // cq, t // ck
    qb = q.reshape(b, nq, cq, h, d).permute(1, 0, 3, 2, 4)          # (nq,B,H,Cq,D)
    kb = k.reshape(b, nk, ck, h, d).permute(1, 0, 3, 2, 4)          # (nk,B,H,Ck,D)
    vb = v.reshape(b, nk, ck, h, d).permute(1, 0, 3, 2, 4)
    q_pos = torch.arange(cq, device=q.device)
    k_pos = torch.arange(ck, device=q.device)
    outs, lses = [], []
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
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))                                   # (B,H,Cq)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, d)
    lse = torch.stack(lses).permute(1, 2, 0, 3).reshape(b, h, s)
    return out, lse


def _flash_bwd(causal: bool, cq: int, ck: int, scale: float, q, k, v, out, lse, dout):
    """The reference's blocked backward: for each k block, over the q
    blocks, p recomputed from the saved LSE; dk and dv carried in float32
    a k block, dq summed in float32 over the k blocks."""
    b, s, h, d = q.shape
    t = k.shape[1]
    nq, nk = s // cq, t // ck
    # row-wise D = sum(dout * out)
    delta = torch.einsum("bshd,bshd->bhs", dout.to(torch.float32), out.to(torch.float32))
    qb = q.reshape(b, nq, cq, h, d).permute(1, 0, 3, 2, 4)          # (nq,B,H,Cq,D)
    dob = dout.reshape(b, nq, cq, h, d).permute(1, 0, 3, 2, 4)
    lseb = lse.reshape(b, h, nq, cq).permute(2, 0, 1, 3)            # (nq,B,H,Cq)
    deltab = delta.reshape(b, h, nq, cq).permute(2, 0, 1, 3)
    kb = k.reshape(b, nk, ck, h, d).permute(1, 0, 3, 2, 4)          # (nk,B,H,Ck,D)
    vb = v.reshape(b, nk, ck, h, d).permute(1, 0, 3, 2, 4)
    q_pos = torch.arange(cq, device=q.device)
    k_pos = torch.arange(ck, device=q.device)
    dq = torch.zeros((nq, b, h, cq, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for kj in range(nk):
        kc, vc = kb[kj], vb[kj]
        dk = torch.zeros((b, h, ck, d), dtype=torch.float32, device=q.device)
        dv = torch.zeros((b, h, ck, d), dtype=torch.float32, device=q.device)
        for qi in range(nq):
            qc, doc = qb[qi], dob[qi]
            sc = torch.einsum("bhqd,bhkd->bhqk", qc, kc).to(torch.float32) * scale
            if causal:
                mask = (qi * cq + q_pos)[:, None] >= (kj * ck + k_pos)[None, :]
                sc = torch.where(mask, sc, NEG_INF)
            p = torch.exp(sc - lseb[qi][..., None])                   # (B,H,Cq,Ck)
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", p.to(doc.dtype), doc)
            dp = torch.einsum("bhqd,bhkd->bhqk", doc, vc).to(torch.float32)
            ds = (p * (dp - deltab[qi][..., None]) * scale).to(qc.dtype)
            dq[qi] += torch.einsum("bhqk,bhkd->bhqd", ds, kc)
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, qc)
        dks.append(dk)
        dvs.append(dv)
    dq = dq.permute(1, 0, 3, 2, 4).reshape(b, s, h, d).to(q.dtype)
    dk = torch.stack(dks).permute(1, 0, 3, 2, 4).reshape(b, t, h, d).to(k.dtype)
    dv = torch.stack(dvs).permute(1, 0, 3, 2, 4).reshape(b, t, h, d).to(v.dtype)
    return dq, dk, dv


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


# -- MLA (Multi-head Latent Attention, DeepSeek-V2) ----------------------------------


def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.mla
    d, h, dt = cfg.d_model, cfg.num_heads, cfg.param_dtype
    return {
        "w_dq": ParamSpec((d, m.q_lora_rank), dt, "scaled", logical=("embed", None)),
        "q_norm": ParamSpec((m.q_lora_rank,), torch.float32, "ones", logical=(None,)),
        "w_uq": ParamSpec((m.q_lora_rank, h, m.qk_nope_dim + m.qk_rope_dim), dt, "scaled",
                          logical=(None, "heads", None)),
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_dim), dt, "scaled",
                           logical=("embed", None)),
        "kv_norm": ParamSpec((m.kv_lora_rank,), torch.float32, "ones", logical=(None,)),
        "w_uk": ParamSpec((m.kv_lora_rank, h, m.qk_nope_dim), dt, "scaled",
                          logical=(None, "heads", None)),
        "w_uv": ParamSpec((m.kv_lora_rank, h, m.v_head_dim), dt, "scaled",
                          logical=(None, "heads", None)),
        "wo": ParamSpec((h, m.v_head_dim, d), dt, "scaled", logical=("heads", None, "embed")),
    }


def mla_compress(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> what MLA caches: c_kv (B, S, kv_lora), normed, and
    k_rope (B, S, rope_dim), rotated."""
    r = cfg.mla.kv_lora_rank
    dkv = x @ params.w_dkv
    c_kv = rmsnorm(dkv[..., :r], params.kv_norm, cfg.rms_eps)
    k_rope = apply_rope(dkv[..., None, r:], positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_queries(params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> q_nope (B, S, H, nope) and q_rope (B, S, H, rope), rotated."""
    nope = cfg.mla.qk_nope_dim
    cq = rmsnorm(x @ params.w_dq, params.q_norm, cfg.rms_eps)
    q = _project(cq, params.w_uq)
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def mla_prefill_attention(params, x: torch.Tensor, positions: torch.Tensor,
                          cfg: ModelConfig, chunk: int, tracer=NULL_TRACER):
    """Full MLA attention by expanding the compressed KV into per-head K/V:
    returns the context (B, S, d) and the cache entries (c_kv, k_rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_rope = mla_queries(params, x, positions, cfg)
    c_kv, k_rope = mla_compress(params, x, positions, cfg)
    k_nope = _project(c_kv, params.w_uk)
    v = _project(c_kv, params.w_uv)
    # the rope part is shared across heads
    h = cfg.num_heads
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.qk_rope_dim)], dim=-1)
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    # v's head dim may be below the qk dim: pad v to it for the shared
    # attention, then slice back
    v_pad = F.pad(v, (0, qk_dim - m.v_head_dim)) if m.v_head_dim < qk_dim else v
    out = blocked_attention(q, k, v_pad, causal=True, chunk=chunk, k_chunk=4 * chunk,
                            softmax_scale=1.0 / math.sqrt(qk_dim), tracer=tracer)
    ctx = output_projection(out[..., :m.v_head_dim], params.wo)
    return ctx, (c_kv, k_rope)


def mla_decode_attention(params, x: torch.Tensor, pos, c_kv_cache: torch.Tensor,
                         k_rope_cache: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Absorbed-matrix MLA decode: x (B, 1, d) at position ``pos`` over the
    caches c_kv (B, S, kv_lora) and k_rope (B, S, rope) whose positions
    <= pos are valid; attention runs in the compressed space."""
    m = cfg.mla
    positions = torch.full(x.shape[:2], int(pos), dtype=torch.int64, device=x.device)
    q_nope, q_rope = mla_queries(params, x, positions, cfg)                # (B,1,H,*)
    # absorb W_UK: q_c[h] = q_nope[h] @ W_UK[h]^T, the compressed-space query
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, params.w_uk)              # (B,1,H,r)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    sc = (torch.einsum("bshr,btr->bhst", q_c, c_kv_cache)
          + torch.einsum("bshk,btk->bhst", q_rope, k_rope_cache)).to(torch.float32) * scale
    valid = torch.arange(c_kv_cache.shape[1], device=x.device)[None, None, None, :] <= pos
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(x.dtype)
    ctx_c = torch.einsum("bhst,btr->bshr", p, c_kv_cache)                   # compressed ctx
    ctx = torch.einsum("bshr,rhk->bshk", ctx_c, params.w_uv)               # expand with W_UV
    return output_projection(ctx, params.wo)
