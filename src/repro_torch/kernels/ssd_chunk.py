"""CUDA kernel: Mamba-2 SSD chunked forward (``csrc/ssd_chunk.cu``).

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

The wrapper takes CUDA tensors only, checks them, allocates y (contiguous,
x's dtype) and the state (B, H, P, N) float32, launches on the current
stream and counts the launch in ``build.LAUNCHES``; ``kernels.ops``
dispatches to it, and the plain version is ``kernels.ref.ssd_scan``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_DIM = 128                 # N and P
MAX_CHUNK = 256


def ssd_chunk_forward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b_: torch.Tensor, c_: torch.Tensor, *, chunk: int = 256,
                      initial_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P) float32 or bfloat16, dt (B, S, H) float32, a (H,) or
    (B, H) float32, b_ and c_ (B, S, G, N) of x's dtype, any strides with
    a contiguous last dim; ``initial_state`` (B, H, P, N) float32 or None
    (zero) -> y (B, S, H, P) in x's dtype and the final state (B, H, P, N)
    float32."""
    bsz, s, h, p, g, n = _check(x, dt, a, b_, c_, chunk, initial_state)
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    a_sb, a_sh = (0, a.stride(0)) if a.dim() == 1 else (a.stride(0), a.stride(1))
    init = None if initial_state is None else initial_state.contiguous()
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.ssd_chunk_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_.data_ptr(), c_.data_ptr(),
            None if init is None else init.data_ptr(),
            y.data_ptr(), state.data_ptr(), bsz, s, h, g, n, p, chunk,
            *(t.stride(i) for t in (x, dt) for i in (0, 1, 2)), a_sb, a_sh,
            *(t.stride(i) for t in (b_, c_, y) for i in (0, 1, 2)),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    build.check("ssd_chunk_forward", err)
    build.LAUNCHES.add("ssd_chunk_forward")
    return y, state


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
