"""Mamba-2 (SSD, state-space duality) mixer, in PyTorch.

A port of the reference's ``repro.models.ssm``: the parameter specs, the
depthwise causal convolution and its one-step form, the chunked SSD scan,
the prefill/training mixer and the O(1)-state decode step, with the
reference's numerics (projections and the intra-chunk products in the
compute dtype, the scan's decays, inter-chunk products and state in
float32, SiLU and softplus in float32).

``ssd_chunked`` is where the TPU kernel's function runs: on a CUDA tensor
it launches the hand-written ``ssd_chunk_forward`` kernel once through
``repro_torch.kernels.ops``, which reads the (B, S, H, P) / (B, S, G, N)
operands in place and returns y and the final state, a ragged last chunk
masked; on a CPU tensor it runs the reference's chunked form (one chunk of
S when the chunk does not divide S, as the reference falls back), ``lax.scan``
becoming a loop over the chunks and ``jnp.repeat`` ``repeat_interleave``.
The two agree up to rounding: the kernel keeps C.B^T in float32 where the
reference's einsum, and the CPU form, round it to the compute dtype.

One deliberate difference from the reference: the cumsum cs of dt*A runs
in float64 (in the CPU form and in the kernel), and each difference of it
is rounded to float32 before its exp.  The reference's float32 cumsum
keeps only |cs| * 2^-24 absolute, and exp(cs_i - cs_j) of two nearby
positions loses that much relative accuracy: at the full-width random
``mamba2-2.7b`` dt*A reaches -150 a position and |cs| 7000 a chunk.  With
such dt (``tests/test_torch_ssm.py::test_ssd_float64_cumsum_at_large_dt``)
the reference's form sits ~8e-4 of the rms from the float64 recurrence,
this form and the float32 sequential recurrence ~2e-6, and this form
within 2e-3 of the rms of the reference's.

``params`` is a module of the mixer's parameters (``layers.{i}.mixer``)
or a dict of tensors by the reference's names.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig, ParamSpec
from repro_torch.models.layers import _leaves, rmsnorm


def ssm_specs(cfg: ModelConfig, d_model: Optional[int] = None) -> Dict[str, ParamSpec]:
    s = cfg.ssm
    assert s is not None
    d = d_model or cfg.d_model
    din = s.d_inner(d)
    h = s.n_heads(d)
    gn = s.n_groups * s.d_state
    dt = cfg.param_dtype
    return {
        "wz": ParamSpec((d, din), dt, "scaled"),
        "wx": ParamSpec((d, din), dt, "scaled"),
        "wB": ParamSpec((d, gn), dt, "scaled"),
        "wC": ParamSpec((d, gn), dt, "scaled"),
        "wdt": ParamSpec((d, h), dt, "scaled"),
        "conv_x": ParamSpec((s.conv_width, din), dt, "scaled"),
        "conv_B": ParamSpec((s.conv_width, gn), dt, "scaled"),
        "conv_C": ParamSpec((s.conv_width, gn), dt, "scaled"),
        "A_log": ParamSpec((h,), torch.float32, "zeros"),
        "D": ParamSpec((h,), torch.float32, "ones"),
        "dt_bias": ParamSpec((h,), torch.float32, "zeros"),
        "norm": ParamSpec((din,), torch.float32, "ones"),
        "out": ParamSpec((din, d), dt, "scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence by shifted adds: x (B, S, C),
    w (W, C)."""
    width = w.shape[0]
    out = x * w[-1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1], :]
        out = out + shifted * w[width - 1 - i]
    return out


def _conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor):
    """One decode step of the causal conv: x_t (B, C), state (B, W-1, C)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)      # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window, w)
    return out, window[:, 1:, :]


def ssd_chunked(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H), post-softplus
    A: torch.Tensor,        # (H,), negative
    B_: torch.Tensor,       # (B, S, G, N)
    C_: torch.Tensor,       # (B, S, G, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: returns (y (B, S, H, P), final_state (B, H, P, N)
    float32)."""
    if x.device.type == "cuda":
        return ops.ssd_chunk_forward(x, dt, A, B_, C_, chunk=chunk,
                                     initial_state=initial_state)
    if x.device.type != "cpu":
        raise ValueError(f"no SSD scan for device {x.device}; expected cpu or cuda")
    f32 = torch.float32
    b, s, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    hg = h // g
    q = min(chunk, s)
    if s % q:
        q = s
    nc = s // q

    def split(t):
        return t.reshape((b, nc, q) + tuple(t.shape[2:])).transpose(0, 1)

    xc, dtc, Bc, Cc = split(x), split(dt).to(f32), split(B_), split(C_)
    state = (initial_state if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=f32, device=x.device))
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys = []
    for ci in range(nc):
        x_, dt_, b_, c_ = xc[ci], dtc[ci], Bc[ci], Cc[ci]
        da = dt_ * A                                            # (B, Q, H), negative
        # inclusive cumsum, and every difference of it, in float64, rounded
        # to float32 before the exp (see the module's docstring)
        cs = torch.cumsum(da.to(torch.float64), dim=1)
        # L[i, j] = exp(cs[i] - cs[j]) for i >= j, masked before the exp
        seg = (cs[:, :, None, :] - cs[:, None, :, :]).to(f32)   # (B, Q, Q, H)
        L = torch.exp(torch.where(causal[None, :, :, None], seg, -1e30))
        cb = torch.einsum("bqgn,bkgn->bgqk", c_, b_).to(f32)
        cb_h = cb.repeat_interleave(hg, dim=1).permute(0, 2, 3, 1)   # (B, Q, K, H)
        m = cb_h * L * dt_[:, None, :, :]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", m.to(x_.dtype), x_).to(f32)
        c_h = c_.repeat_interleave(hg, dim=2)                   # (B, Q, H, N)
        y_inter = torch.einsum("bqhn,bhpn->bqhp",
                               c_h.to(f32) * torch.exp(cs.to(f32))[..., None], state)
        decay_out = torch.exp((cs[:, -1, None, :] - cs).to(f32))   # (B, Q, H)
        b_h = b_.repeat_interleave(hg, dim=2)
        dstate = torch.einsum("bqhn,bqhp->bhpn",
                              b_h.to(f32) * (dt_ * decay_out)[..., None], x_.to(f32))
        state = torch.exp(cs[:, -1].to(f32))[:, :, None, None] * state + dstate
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys).transpose(0, 1).reshape(b, s, h, p)
    return y, state


def _silu_to(x: torch.Tensor, dtype) -> torch.Tensor:
    return F.silu(x.to(torch.float32)).to(dtype)


def _project(p: Dict[str, torch.Tensor], x: torch.Tensor):
    """z, x, B, C in the compute dtype and dt in float32 (before softplus)."""
    return (x @ p["wz"], x @ p["wx"], x @ p["wB"], x @ p["wC"],
            (x @ p["wdt"]).to(torch.float32))


def _gated_out(p: Dict[str, torch.Tensor], y: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Gated RMSNorm (Mamba-2 style), then the output projection."""
    y = rmsnorm(y * _silu_to(z, y.dtype), p["norm"], cfg.rms_eps)
    return y @ p["out"]


def ssm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                d_model: Optional[int] = None) -> torch.Tensor:
    """Full Mamba-2 mixer for training and prefill: x (B, S, d) -> (B, S, d)."""
    out, *_ = _mixer(params, x, cfg, d_model)
    return out


def _mixer(params, x: torch.Tensor, cfg: ModelConfig, d_model: Optional[int] = None):
    """The mixer over a sequence: its output, the final SSM state and the
    raw (pre-conv) x, B and C projections."""
    p = _leaves(params)
    s_cfg = cfg.ssm
    d = d_model or cfg.d_model
    din = s_cfg.d_inner(d)
    h = s_cfg.n_heads(d)
    hp = s_cfg.head_dim
    g, n = s_cfg.n_groups, s_cfg.d_state

    z, xi_raw, bv_raw, cv_raw, dt = _project(p, x)
    xi = _silu_to(_causal_conv(xi_raw, p["conv_x"]), x.dtype)
    bv = _silu_to(_causal_conv(bv_raw, p["conv_B"]), x.dtype)
    cv = _silu_to(_causal_conv(cv_raw, p["conv_C"]), x.dtype)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    b, s = x.shape[:2]
    y, state = ssd_chunked(xi.reshape(b, s, h, hp), dt, A, bv.reshape(b, s, g, n),
                           cv.reshape(b, s, g, n), chunk=s_cfg.chunk)
    y = y + xi.reshape(b, s, h, hp) * p["D"][None, None, :, None].to(x.dtype)
    out = _gated_out(p, y.reshape(b, s, din), z, cfg)
    return out, state, xi_raw, bv_raw, cv_raw


def ssm_init_cache(cfg: ModelConfig, batch: int, d_model: Optional[int] = None,
                   dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    d = d_model or cfg.d_model
    din = s.d_inner(d)
    h = s.n_heads(d)
    gn = s.n_groups * s.d_state
    return {
        "state": torch.zeros((batch, h, s.head_dim, s.d_state), dtype=torch.float32,
                             device=device),
        "conv_x": torch.zeros((batch, s.conv_width - 1, din), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, s.conv_width - 1, gn), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, s.conv_width - 1, gn), dtype=dtype, device=device),
    }


def ssm_decode_step(params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cfg: ModelConfig, d_model: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """O(1)-state decode step: x (B, 1, d) and the layer's cache -> the
    mixer output (B, 1, d) and the new cache (new tensors)."""
    p = _leaves(params)
    s_cfg = cfg.ssm
    d = d_model or cfg.d_model
    din = s_cfg.d_inner(d)
    h = s_cfg.n_heads(d)
    hp = s_cfg.head_dim
    g, n = s_cfg.n_groups, s_cfg.d_state
    hg = h // g

    z, xi, bv, cv, dt = _project(p, x[:, 0, :])
    xi, conv_x = _conv_step(xi, cache["conv_x"], p["conv_x"])
    bv, conv_B = _conv_step(bv, cache["conv_B"], p["conv_B"])
    cv, conv_C = _conv_step(cv, cache["conv_C"], p["conv_C"])
    xi, bv, cv = (F.silu(t.to(torch.float32)) for t in (xi, bv, cv))

    dt = F.softplus(dt + p["dt_bias"])                    # (B, H)
    A = -torch.exp(p["A_log"])                             # (H,)
    da = torch.exp(dt * A)                                 # (B, H)

    xh = xi.reshape(-1, h, hp)
    bh = bv.reshape(-1, g, n).repeat_interleave(hg, dim=1)     # (B, H, N)
    ch = cv.reshape(-1, g, n).repeat_interleave(hg, dim=1)
    state = cache["state"] * da[:, :, None, None] + torch.einsum(
        "bhn,bhp,bh->bhpn", bh, xh, dt)
    y = torch.einsum("bhpn,bhn->bhp", state, ch) + xh * p["D"][None, :, None]
    y = y.reshape(-1, din).to(x.dtype)
    out = _gated_out(p, y, z, cfg)[:, None, :]
    return out, {"state": state, "conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C}
