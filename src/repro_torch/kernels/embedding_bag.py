"""CUDA kernel: pooled embedding bag (``csrc/embedding_bag.cu``).

Counterpart of the reference's Pallas ``repro.kernels.embedding_bag``:
``out[b] = sum_l mask[b,l] * table[ids[b,l]]``, summed over l in order
with every slot included, and in "mean" mode divided by
``max(sum_l mask[b,l], 1)``.  ``repro_torch.train.embedding_cache``
launches it once per lookup over the flattened hot-slot table.

The wrapper takes CUDA tensors only, checks them, allocates the output,
launches on the current stream and counts the launch in
``build.LAUNCHES``; the plain version lives in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_EMBED_DIM = 1024      # one thread per column, one block per bag


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  mode: str = "mean") -> torch.Tensor:
    """table (V, E) f32, ids (B, L) int32 in [0, V) (clamped), mask (B, L)
    f32 -> (B, E) f32."""
    if mode not in ("mean", "sum"):
        raise ValueError(f"mode must be 'mean' or 'sum', got {mode!r}")
    for name, t, dtype in (("table", table, torch.float32), ("ids", ids, torch.int32),
                           ("mask", mask, torch.float32)):
        if t.device.type != "cuda":
            raise ValueError(f"embedding_bag {name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"embedding_bag {name}: expected a contiguous 2-D {dtype} tensor, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    if not (table.device == ids.device == mask.device):
        raise ValueError("embedding_bag: operands on different devices")
    if ids.shape != mask.shape:
        raise ValueError(f"embedding_bag: ids {tuple(ids.shape)} != mask {tuple(mask.shape)}")
    v, e = table.shape
    b, l = ids.shape
    if v < 1 or not 1 <= e <= MAX_EMBED_DIM:
        raise ValueError(f"embedding_bag: table {tuple(table.shape)} needs V >= 1 and "
                         f"1 <= E <= {MAX_EMBED_DIM}")
    if b >= 2 ** 31 or l >= 2 ** 31:
        raise ValueError(f"embedding_bag: ids {tuple(ids.shape)} too large for one launch")
    out = torch.empty((b, e), dtype=torch.float32, device=table.device)
    lib = build.library()
    with torch.cuda.device(table.device):
        err = lib.embedding_bag_launch(
            table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
            v, e, b, l, int(mode == "mean"), torch.cuda.current_stream().cuda_stream,
        )
    build.check("embedding_bag", err)
    build.LAUNCHES.add("embedding_bag")
    return out
