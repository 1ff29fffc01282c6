"""Mixture-of-Experts FFN with capacity-based dispatch and expert parallelism.

A port of the reference's ``repro.models.moe``.  Routing is top-k softmax
gating in float32 with a capacity factor (Switch-style token dropping);
shared experts (DeepSeek-V2 / Kimi-K2) run densely for all tokens.

``moe_forward`` on one device is the reference's global dispatch: a
segmented cumsum gives every (token, k) slot its position within its
expert; slots past the capacity are dropped into a spill column of the
(E, cap + 1) dispatch table, which is discarded; the tokens are gathered
to (E, cap, d), the three expert products run as batched matmuls, and
each token reads its k outputs back, weighted by its gates.  The
reference computes these products with ``einsum`` outside any Pallas
kernel, so here they are ``torch.bmm``: no kernel of the port is on this
path.

Under ``distributed.context.sharding_context`` with a mesh whose "model"
axis is above 1 and divides ``num_experts``, ``moe_forward`` takes the
expert-parallel path (``moe_forward_ep``), as the reference does: each
rank holds its ``num_experts / n_model`` slice of the three expert leaves
(``expert_rows``; ``repro_torch.convert.moe_shard_from_numpy`` cuts it)
and the whole router, routes the tokens it holds (its data shard) with
global expert ids, computes only its own experts with the capacity of its
local token count, and the partial outputs are summed over "model"; aux
is averaged over "model".  Under autograd (the sharded train step) the
sums pass gradients through and the tokens' and router's gradients are
summed over "model" (``distributed.collectives``): the backward of the
reference's ``shard_map``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import copy_to, reduce_from
from repro_torch.distributed.context import current_context
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig, MoEConfig, ParamSpec


def moe_specs(cfg: ModelConfig, moe: Optional[MoEConfig] = None) -> Dict[str, Any]:
    m = moe or cfg.moe
    d, dt = cfg.d_model, cfg.param_dtype
    specs: Dict[str, Any] = {
        "router": ParamSpec((d, m.num_experts), torch.float32, "scaled",
                            logical=("embed", None)),
        "wi_gate": ParamSpec((m.num_experts, d, m.d_ff), dt, "scaled",
                             logical=("expert", "embed", None)),
        "wi_up": ParamSpec((m.num_experts, d, m.d_ff), dt, "scaled",
                           logical=("expert", "embed", None)),
        "wo": ParamSpec((m.num_experts, m.d_ff, d), dt, "scaled",
                        logical=("expert", None, "embed")),
    }
    if m.num_shared_experts:
        shared_ff = m.shared_d_ff or m.num_shared_experts * m.d_ff
        specs["shared"] = layers.mlp_specs(d, shared_ff, dt)
    return specs


def _capacity(num_tokens: int, m: MoEConfig) -> int:
    cap = int(num_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, (cap + 7) // 8 * 8)  # 8-aligned, non-degenerate


def route(router_w: torch.Tensor, x: torch.Tensor,
          m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) -> (expert_idx (T, k) int64, gates (T, k) in x's dtype,
    aux_loss float32 scalar)."""
    logits = x.to(m.router_dtype) @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch/GShard form)
    density = F.one_hot(idx[:, 0], m.num_experts).to(torch.float32).mean(dim=0)
    aux = torch.sum(density * probs.mean(dim=0)) * m.num_experts
    return idx, gates.to(x.dtype), aux


def _dispatch_compute(xf: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor,
                      wi_gate: torch.Tensor, wi_up: torch.Tensor, wo: torch.Tensor,
                      num_experts: int, e_start: int, cap: int) -> torch.Tensor:
    """The experts [e_start, e_start + E_loc) of ``wi_gate``'s first axis
    applied to the (T, k) slots routed to them, at most ``cap`` an expert
    in slot order; returns the gate-weighted sum over k of those outputs
    (T, d), zero where a slot went elsewhere or was dropped."""
    t, d = xf.shape
    k = idx.shape[1]
    e_local = wi_gate.shape[0]
    dev = xf.device
    # position of each (token, k) within its expert via a segmented cumsum
    onehot = F.one_hot(idx, num_experts)                             # (T,k,E)
    flat = onehot.reshape(t * k, num_experts)
    before = (torch.cumsum(flat, dim=0) - flat).reshape(t, k, num_experts)
    pos = before.gather(-1, idx[..., None])[..., 0]                  # (T,k)
    local_e = idx - e_start
    keep = (local_e >= 0) & (local_e < e_local) & (pos < cap)

    # scatter token ids into the (E_loc, C) dispatch table; dropped slots
    # land in the spill column cap, whose duplicate writes are discarded
    token_ids = torch.arange(t, device=dev)[:, None].expand(t, k)
    safe_e = torch.where(keep, local_e, 0)
    safe_p = torch.where(keep, pos, cap)
    table = torch.full((e_local, cap + 1), t, dtype=torch.int64, device=dev)
    table.index_put_((safe_e.reshape(-1), safe_p.reshape(-1)),
                     torch.where(keep, token_ids, t).reshape(-1))
    slot_token = table[:, :cap]                                      # (E_loc, C)

    # gather tokens (pad row t = zeros), run experts, read back
    xpad = torch.cat([xf, xf.new_zeros((1, d))])
    xe = xpad[slot_token]                                            # (E_loc, C, d)
    gate_lin = torch.bmm(xe, wi_gate)
    up = torch.bmm(xe, wi_up)
    hidden = F.silu(gate_lin.to(torch.float32)).to(xe.dtype) * up
    ye = torch.bmm(hidden, wo)                                       # (E_loc, C, d)

    ypad = torch.cat([ye.reshape(-1, d), ye.new_zeros((1, d))])
    slot_flat = torch.where(keep, safe_e * cap + safe_p, e_local * cap)
    yk = ypad[slot_flat]                                             # (T,k,d)
    return torch.sum(yk * gates[..., None], dim=1)


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig,
                moe: Optional[MoEConfig] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (output (B, S, d), aux_loss).  ``params`` is the
    FFN's module or a dict of its leaves (``shared`` a module or dict)."""
    m = moe or cfg.moe
    ctx = current_context()
    if ctx is not None:
        mesh, _ = ctx
        n_model = mesh.shape.get("model", 1)
        if n_model > 1 and m.num_experts % n_model == 0:
            return moe_forward_ep(params, x, cfg, mesh, m)
    p = layers._leaves(params)
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    idx, gates, aux = route(p["router"], xf, m)
    y = _dispatch_compute(xf, idx, gates, p["wi_gate"], p["wi_up"], p["wo"],
                          m.num_experts, 0, _capacity(t, m))
    if m.num_shared_experts:
        y = y + layers.mlp(p["shared"], xf)
    return y.reshape(b, s, d), aux


def expert_rows(num_experts: int, mesh) -> Tuple[int, int]:
    """The experts [lo, hi) that this rank holds on ``mesh``: its slice of
    the "model" axis where that axis divides ``num_experts`` (the
    condition under which ``moe_forward`` is expert-parallel), else every
    expert, as on no mesh (``mesh`` None)."""
    n = 1 if mesh is None else mesh.shape.get("model", 1)
    if n == 1 or num_experts % n:
        return 0, num_experts
    per = num_experts // n
    c = mesh.coord("model")
    return c * per, (c + 1) * per


def moe_forward_ep(params, x: torch.Tensor, cfg: ModelConfig, mesh,
                   m: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel forward of this rank: ``x`` (B_loc, S, d) is
    the tokens it holds, ``params`` holds its ``expert_rows`` slice of
    the expert leaves and the whole router and shared experts.  Returns
    the output of its tokens, summed over "model", and aux averaged over
    "model"."""
    p = layers._leaves(params)
    b, s, d = x.shape
    lo, hi = expert_rows(m.num_experts, mesh)
    if p["wi_gate"].shape[0] != hi - lo:
        raise ValueError(f"rank holds {p['wi_gate'].shape[0]} experts, expected its slice "
                         f"[{lo}, {hi}) of {m.num_experts}")
    xf = x.reshape(b * s, d)
    # the region of this rank's experts: its inputs' gradients are summed
    # over "model" (each rank differentiates only its experts' share), its
    # outputs' passed through (each rank's loss reads the sums)
    xr, router = copy_to(xf, mesh, "model"), copy_to(p["router"], mesh, "model")
    idx, gates, aux = route(router, xr, m)
    y_partial = _dispatch_compute(xr, idx, gates, p["wi_gate"], p["wi_up"], p["wo"],
                                  m.num_experts, lo, _capacity(b * s, m))
    y = reduce_from(y_partial, mesh, "model")
    aux = reduce_from(aux, mesh, "model") / mesh.shape["model"]
    if m.num_shared_experts:
        y = y + layers.mlp(p["shared"], xf)
    return y.reshape(b, s, d), aux
