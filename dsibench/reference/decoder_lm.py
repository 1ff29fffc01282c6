"""Plain reference of a dense GQA decoder's training steps (Qwen3-style:
RMSNorm before attention and MLP, q/k RMSNorm over the head dim, rotary
embedding in split-halves form, causal softmax attention with each KV
head shared by ``num_heads / num_kv_heads`` query heads, SwiGLU MLP, an
untied output head, mean cross-entropy over every token), followed by
``adamw.AdamW``.

Computed in float32 with TF32 off; parameters are stored in the
configuration's types (bf16 matrices and token table, float32 norm
scales), so each update is rounded to bf16 as the configuration states.
``precision="fp8"`` is the control: every matrix product of the
projections, the MLP and the head runs as FP8 training runs it, its
operands rounded to float8 e4m3 in the forward and the gradient flowing
back rounded to float8 e5m2 in the backward (each under a per-tensor
scale to its largest magnitude); the rest is the same.
Each layer runs under activation checkpointing and attention one batch
row at a time, so the reference fits beside nothing else on the card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dsibench import weights as W
from dsibench.reference.adamw import AdamW

LOGIT_ROWS = 1024          # positions of the head's logits at a time


def fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to a float8 type under a per-tensor scale that maps its
    largest magnitude to the type's largest, back in float32."""
    s = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / s).to(dtype).to(torch.float32) * s


class FP8MatMul(torch.autograd.Function):
    """(..., k) @ (k, n) with e4m3 operands, and an e5m2 gradient in the
    backward's two products."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g, torch.float8_e5m2)
        ga = qg @ qb.T
        gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (B, S, heads, D) at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Model:
    def __init__(self, m: Dict[str, Any], precision: str):
        self.m = m
        self.fp8 = precision == "fp8"

    def mm(self, a, b):
        return FP8MatMul.apply(a, b) if self.fp8 else a @ b

    def layer(self, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        m = self.m
        b, s, d = x.shape
        h, kvh, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        eps = m["rms_eps"]
        hn = rmsnorm(x, p["ln1"], eps)
        q = self.mm(hn, p["attn.wq"].reshape(d, h * hd)).view(b, s, h, hd)
        k = self.mm(hn, p["attn.wk"].reshape(d, kvh * hd)).view(b, s, kvh, hd)
        v = self.mm(hn, p["attn.wv"].reshape(d, kvh * hd)).view(b, s, kvh, hd)
        if m.get("qk_norm"):
            q = rmsnorm(q, p["attn.q_norm"], eps)
            k = rmsnorm(k, p["attn.k_norm"], eps)
        q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        rows = []
        for r in range(b):
            sc = torch.einsum("shd,thd->hst", q[r], k[r]) / math.sqrt(hd)
            pr = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
            rows.append(torch.einsum("hst,thd->shd", pr, v[r]))
        o = torch.stack(rows).reshape(b, s, h * hd)
        x = x + self.mm(o, p["attn.wo"].reshape(h * hd, d))
        hn = rmsnorm(x, p["ln2"], eps)
        f = F.silu(self.mm(hn, p["ffn.wi_gate"])) * self.mm(hn, p["ffn.wi_up"])
        return x + self.mm(f, p["ffn.wo"])

    def loss(self, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        m = self.m
        x = params["embed.tok"][tokens.long()]
        for i in range(m["num_layers"]):
            lp = {k[len(f"layers.{i}."):]: v for k, v in params.items()
                  if k.startswith(f"layers.{i}.")}
            x = checkpoint(self.layer, lp, x, use_reentrant=False)
        x = rmsnorm(x, params["ln_f"], m["rms_eps"]).reshape(-1, m["d_model"])
        lab = labels.long().reshape(-1)
        total = x.new_zeros(())
        for c in range(0, x.shape[0], LOGIT_ROWS):
            total = total + checkpoint(self._xent, x[c:c + LOGIT_ROWS], lab[c:c + LOGIT_ROWS],
                                       params["embed.out"], use_reentrant=False)
        return total / x.shape[0]

    def _xent(self, x, lab, w):
        return F.cross_entropy(self.mm(x, w), lab, reduction="sum")


def decayed(params: Dict[str, torch.Tensor]) -> List[str]:
    """The configuration's weight-decay rule: every matrix and every leaf
    of a layer (a layer's leaves form stacks of two or more dimensions)."""
    return [k for k, p in params.items() if p.dim() >= 2 or k.startswith("layers.")]


def run(model: Dict[str, Any], opt: Dict[str, Any], seed: int,
        batches: List[Tuple[np.ndarray, np.ndarray]], device, precision: str = "float32"
        ) -> Dict[str, Any]:
    """The reference's steps over ``batches`` (tokens, labels) from the
    weights of ``seed``: each step's loss, each leaf's first clipped
    gradient norm (as the optimizer takes it) and each leaf's change
    after the last step."""
    dtype = getattr(torch, model["param_dtype"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        init = W.lm_weights(model, seed, device, dtype)
        params = {k: v.float().requires_grad_(True) for k, v in init.items()}
        kinds = {k: v.dtype for k, v in init.items()}
        del init
        net = Model(model, precision)
        adam = AdamW(opt, params, decayed(params))
        losses, first = [], None
        for tokens, labels in batches:
            t = torch.as_tensor(np.ascontiguousarray(tokens), device=device)
            y = torch.as_tensor(np.ascontiguousarray(labels), device=device)
            loss = net.loss(params, t, y)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                g = adam.step({k: p.data for k, p in params.items()}, grads,
                              store=lambda p: p)
                for k, p in params.items():
                    p.data.copy_(p.data.to(kinds[k]).float())
            if first is None:
                first = {k: float(torch.linalg.vector_norm(v)) for k, v in g.items()}
            del grads, g
        start = W.lm_weights(model, seed, device, dtype)
        change = {k: float(torch.linalg.vector_norm(params[k].detach() - start[k].float()))
                  for k in params}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"losses": losses, "grad": first, "change": change}
