"""CUDA kernels: Mamba-2 SSD chunked forward, two routes.

Counterpart of the reference's Pallas ``repro.kernels.ssd_chunk``: per
(batch, head) the chunked SSD scan, the intra-chunk ``((C.B^T) o L) x``
with m rounded to x's type, plus the carried state's contribution, the
(N, P) float32 state carried from chunk to chunk.  Unlike the TPU kernel it
also returns the final state, which the SSM prefill caches, and it reads
the model's layout in place: x (B, S, H, P), dt (B, S, H), A per head and
B, C (B, S, G, N) with head h reading group h // (H/G); neither a
transpose nor the expansion of B and C to heads is materialized.  The TPU
kernel's (BH, S, P) form is the case H = G = 1 with A of shape (BH, 1).
A ragged last chunk is masked rather than refused.

Two kernels compute it; ``route`` picks one from the operands before the
launch:

* ``"sm90"`` (``csrc/ssd_chunk_sm90.cu``): the products on the tensor
  cores (wgmma, operands staged by 16-byte cp.async).  It takes bf16 x,
  B and C with P and N of 64 or 128, a chunk that is a multiple of 64 up
  to 256, and views whose rows 16-byte copies can read: the rule of
  ``flash_attention.tma_strides`` (the last dim contiguous, every other
  byte stride a positive multiple of 16, the base 16-byte aligned).
  Counted as ``ssd_chunk_forward_sm90``.  Its rounding points differ from the FMA
  kernel's (``sm90_form`` mirrors them in plain PyTorch).
* ``"fma"`` (``csrc/ssd_chunk.cu``): float32 FMAs on the CUDA cores, N and
  P up to 128, any chunk up to 256, float32 or bf16, any strides with a
  contiguous last dim.  It takes every other call.  Counted as
  ``ssd_chunk_forward``.

The rule is a dispatch on the operands, not a fallback: a call that the
tensor-core route takes raises if that kernel fails to build or launch.
``ssd_chunk_forward_fma`` and ``ssd_chunk_forward_sm90`` launch one route
each (the latter raises on operands it does not take), so the two can be
timed on the same operands.

The wrappers take CUDA tensors only, check them, allocate y (contiguous,
x's dtype) and the state (B, H, P, N) float32, launch on the current
stream and count the launch in ``build.LAUNCHES``; ``kernels.ops``
dispatches to ``ssd_chunk_forward``, and the plain version is
``kernels.ref.ssd_scan``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import tma_strides

MAX_DIM = 128                 # N and P
MAX_CHUNK = 256
SM90_DIMS = (64, 128)         # P and N the tensor-core route takes
SM90_CHUNK_STEP = 64          # its chunk: a multiple of this, up to MAX_CHUNK


def route(x: torch.Tensor, b_: torch.Tensor, c_: torch.Tensor, chunk: int) -> str:
    """``"sm90"`` for bf16 x, B and C with P and N in (64, 128), a chunk
    that is a multiple of 64 up to 256 and views ``tma_strides`` accepts
    (its 16-byte rule is cp.async's), else ``"fma"``.  Reads only dtypes, shapes, strides and base
    addresses, so it decides the same on any device."""
    if any(t.dtype != torch.bfloat16 for t in (x, b_, c_)):
        return "fma"
    if x.dim() != 4 or b_.dim() != 4:
        return "fma"
    if x.shape[3] not in SM90_DIMS or b_.shape[3] not in SM90_DIMS:
        return "fma"
    if chunk % SM90_CHUNK_STEP or not SM90_CHUNK_STEP <= chunk <= MAX_CHUNK:
        return "fma"
    if any(tma_strides(t) is None for t in (x, b_, c_)):
        return "fma"
    return "sm90"


def ssd_chunk_forward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b_: torch.Tensor, c_: torch.Tensor, *, chunk: int = 256,
                      initial_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P) float32 or bfloat16, dt (B, S, H) float32, a (H,) or
    (B, H) float32, b_ and c_ (B, S, G, N) of x's dtype, any strides with
    a contiguous last dim; ``initial_state`` (B, H, P, N) float32 or None
    (zero) -> y (B, S, H, P) in x's dtype and the final state (B, H, P, N)
    float32, through the route ``route`` picks."""
    _check(x, dt, a, b_, c_, chunk, initial_state)
    launch = _launch_sm90 if route(x, b_, c_, chunk) == "sm90" else _launch_fma
    return launch(x, dt, a, b_, c_, chunk, initial_state)


def ssd_chunk_forward_fma(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                          b_: torch.Tensor, c_: torch.Tensor, *, chunk: int = 256,
                          initial_state: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FMA route, whatever ``route`` would pick."""
    _check(x, dt, a, b_, c_, chunk, initial_state)
    return _launch_fma(x, dt, a, b_, c_, chunk, initial_state)


def ssd_chunk_forward_sm90(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                           b_: torch.Tensor, c_: torch.Tensor, *, chunk: int = 256,
                           initial_state: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core route; raises on operands it does not take."""
    _check(x, dt, a, b_, c_, chunk, initial_state)
    if route(x, b_, c_, chunk) != "sm90":
        raise ValueError(f"ssd_chunk_forward_sm90: takes bf16 with P and N in {SM90_DIMS}, a "
                         f"chunk that is a multiple of {SM90_CHUNK_STEP} up to {MAX_CHUNK} "
                         f"and 16-byte aligned views, got {x.dtype} x {tuple(x.shape)} "
                         f"strides {x.stride()}, B {tuple(b_.shape)} strides {b_.stride()}, "
                         f"C strides {c_.stride()}, chunk {chunk}")
    return _launch_sm90(x, dt, a, b_, c_, chunk, initial_state)


def _outputs(x, b_):
    bsz, s, h, p = x.shape
    n = b_.shape[3]
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    return y, state


def _a_strides(a):
    return (0, a.stride(0)) if a.dim() == 1 else (a.stride(0), a.stride(1))


def _launch_fma(x, dt, a, b_, c_, chunk, initial_state):
    bsz, s, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    y, state = _outputs(x, b_)
    init = None if initial_state is None else initial_state.contiguous()
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_chunk_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_.data_ptr(), c_.data_ptr(),
            None if init is None else init.data_ptr(),
            y.data_ptr(), state.data_ptr(), bsz, s, h, g, n, p, chunk,
            *(t.stride(i) for t in (x, dt) for i in (0, 1, 2)), *_a_strides(a),
            *(t.stride(i) for t in (b_, c_, y) for i in (0, 1, 2)),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    build.check("ssd_chunk_forward", err)
    build.LAUNCHES.add("ssd_chunk_forward")
    return y, state


def _launch_sm90(x, dt, a, b_, c_, chunk, initial_state):
    bsz, s, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    y, state = _outputs(x, b_)
    init = None if initial_state is None else initial_state.contiguous()
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_chunk_sm90_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_.data_ptr(), c_.data_ptr(),
            None if init is None else init.data_ptr(),
            y.data_ptr(), state.data_ptr(), bsz, s, h, g, n, p, chunk,
            *(t.stride(i) for t in (x, dt) for i in (0, 1, 2)), *_a_strides(a),
            *(t.stride(i) for t in (b_, c_, y) for i in (0, 1, 2)),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check("ssd_chunk_forward_sm90", err)
    build.LAUNCHES.add("ssd_chunk_forward_sm90")
    return y, state


def sm90_form(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_: torch.Tensor,
              c_: torch.Tensor, chunk: int,
              initial_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core route's decomposition in plain PyTorch, on any
    device, with its roundings: per chunk, cs the float64 cumsum of the
    float32 dt*A; within a 64-position block (and above the diagonal
    nothing) m = (C.B^T) * 2^((hi_i - hi_j) + (lo_i - lo_j)) * dt_j (hi, lo
    the float32 parts of cs * log2(e)); below it, for key block J ending at
    r, m = ((C.B^T) * 2^((hi_i - hi_r) + (lo_i - lo_r))) * (dt_j * 2^((hi_r
    - hi_j) + (lo_r - lo_j))); m to bf16;
    y = exp(cs_i) (C . bf16(state)) + m . x, to bf16; state = exp(cs_last)
    state + hi^T B + lo^T B with hi = bf16(x w), lo = bf16(x w - hi), w_j =
    dt_j exp(cs_last - cs_j).  Products of bf16 operands are exact in
    float32, so only the order of the float32 sums differs from the
    kernel (and ex2.approx from exp2).  Shapes as ``ssd_chunk_forward``;
    bf16 x, B and C."""
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    bsz, s, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    hg = h // g
    a = a.to(f32).expand(bsz, h)
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) if initial_state is None
             else initial_state.to(f32).clone())
    ys = []
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        xq = x[:, c0:c0 + q].to(f32)                                     # (B, Q, H, P)
        dq = dt[:, c0:c0 + q].to(f32)                                    # (B, Q, H)
        bq = b_[:, c0:c0 + q].to(f32).repeat_interleave(hg, 2)           # (B, Q, H, N)
        cq = c_[:, c0:c0 + q].to(f32).repeat_interleave(hg, 2)
        cs = torch.cumsum((dq * a[:, None, :]).to(f64), dim=1)           # (B, Q, H)
        cs2 = cs * (1 / math.log(2))
        hi = cs2.to(f32)
        lo = (cs2 - hi.to(f64)).to(f32)
        cs_last = cs[:, -1:]
        w = dq * torch.exp((cs_last - cs).to(f32))
        diff = (hi[:, :, None] - hi[:, None]) + (lo[:, :, None] - lo[:, None])  # (B, Qi, Qj, H)
        pos = torch.arange(q, device=x.device)
        causal = pos[:, None] >= pos[None, :]
        below = (pos[:, None] // 64) > (pos[None, :] // 64)       # below the diagonal blocks
        r = (pos | 63).clamp(max=q - 1)                           # the end of j's key block
        hi_r, lo_r = hi[:, r], lo[:, r]                           # (B, Qj, H)
        row_f = torch.exp2((hi[:, :, None] - hi_r[:, None]) + (lo[:, :, None] - lo_r[:, None]))
        col_f = dq * torch.exp2((hi_r - hi) + (lo_r - lo))        # (B, Qj, H)
        cb = torch.einsum("bihn,bjhn->bijh", cq, bq)
        m = torch.where(below[None, :, :, None], (cb * row_f) * col_f[:, None],
                        (cb * torch.exp2(diff)) * dq[:, None])
        m = torch.where(causal[None, :, :, None], m, 0.0).to(bf16).to(f32)
        y_in = torch.einsum("bihn,bhpn->bihp", cq, state.to(bf16).to(f32))
        y = torch.exp(cs.to(f32))[..., None] * y_in + torch.einsum("bijh,bjhp->bihp", m, xq)
        ys.append(y.to(x.dtype))
        xw = xq * w[..., None]
        xw_hi = xw.to(bf16).to(f32)
        xw_lo = (xw - xw_hi).to(bf16).to(f32)
        state = torch.exp(cs_last.to(f32))[:, 0, :, None, None] * state + (
            torch.einsum("bjhp,bjhn->bhpn", xw_hi, bq) + torch.einsum("bjhp,bjhn->bhpn", xw_lo, bq))
    return torch.cat(ys, dim=1), state


def _check(x, dt, a, b_, c_, chunk, initial_state):
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b_", b_), ("c_", c_),
                    ("initial_state", initial_state)):
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"ssd_chunk_forward {name}: expected a CUDA tensor, got {t.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_chunk_forward x: expected float32 or bfloat16, got {x.dtype}")
    for name, t in (("b_", b_), ("c_", c_)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_chunk_forward {name}: expected {x.dtype} like x, got {t.dtype}")
    for name, t in (("dt", dt), ("a", a), ("initial_state", initial_state)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"ssd_chunk_forward {name}: expected float32, got {t.dtype}")
    for name, t in (("x", x), ("b_", b_), ("c_", c_)):
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"ssd_chunk_forward {name}: expected a 4-D tensor with a "
                             f"contiguous last dim, got {tuple(t.shape)} strides {t.stride()}")
    if len({t.device for t in (x, dt, a, b_, c_)}) != 1:
        raise ValueError("ssd_chunk_forward: operands on different devices")
    bsz, s, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(b_.shape[:2]) != (bsz, s)
            or c_.shape != b_.shape or tuple(a.shape) not in ((h,), (bsz, h))):
        raise ValueError(f"ssd_chunk_forward: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, b_ {tuple(b_.shape)}, c_ {tuple(c_.shape)} do "
                         "not fit (B, S, H, P), (B, S, H), (H,) or (B, H), (B, S, G, N)")
    if g < 1 or h % g:
        raise ValueError(f"ssd_chunk_forward: {h} heads over {g} groups")
    if not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"ssd_chunk_forward: head dim {p} and state dim {n} must be in "
                         f"[1, {MAX_DIM}]")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_chunk_forward: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if bsz < 1 or s < 1:
        raise ValueError(f"ssd_chunk_forward: empty operand x {tuple(x.shape)}")
    if bsz * h >= 2 ** 31 or s >= 2 ** 31:
        raise ValueError(f"ssd_chunk_forward: x {tuple(x.shape)} too large for one launch")
    if initial_state is not None and tuple(initial_state.shape) != (bsz, h, p, n):
        raise ValueError(f"ssd_chunk_forward: initial_state {tuple(initial_state.shape)}, "
                         f"expected {(bsz, h, p, n)}")
    return bsz, s, h, p, g, n
