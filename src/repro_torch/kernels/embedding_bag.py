"""CUDA kernels: pooled embedding bag, two routes (``csrc/embedding_bag.cu``).

Counterpart of the reference's Pallas ``repro.kernels.embedding_bag``:
``out[b] = sum_l mask[b,l] * table[ids[b,l]]``, summed over l in order
with every slot included, and in "mean" mode divided by
``max(sum_l mask[b,l], 1)``.  ``repro_torch.train.embedding_cache``
launches it once per lookup over the flattened hot-slot table.

Two kernels compute it; ``route`` picks one from the operands before the
launch:

* ``"warp"``: one warp a bag, a float4 of each 128-column stripe a lane,
  ids and mask handed out by shuffles, a group of row loads in flight
  before the first add.  It takes E a multiple of 4 up to 512 with a
  16-byte aligned table (the output is a fresh allocation): the trainer's
  E = 128 lookups.  Counted as ``embedding_bag_warp``.
* ``"block"``: one block a bag, one thread a column, E up to 1024.  It
  takes every other call.  Counted as ``embedding_bag``.

The rule is a dispatch on the operands, not a fallback: a call that the
warp route takes raises if that kernel fails to build or launch.
``embedding_bag_warp`` and ``embedding_bag_block`` launch one route each
(the former raises on operands it does not take), so the two can be timed
on the same operands.  Both add the slots in order with the same
roundings, so both give the plain version's bits.

The wrappers take CUDA tensors only, check them, allocate the output,
launch on the current stream and count the launch in ``build.LAUNCHES``;
the plain version lives in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_EMBED_DIM = 1024      # the block route: one thread per column, one block per bag
WARP_MAX_EMBED_DIM = 512  # the warp route: four 128-column stripes of float4s
WARP_ALIGN = 16           # bytes: the warp route's table base and row alignment


def route(table: torch.Tensor) -> str:
    """``"warp"`` for E a multiple of 4 up to 512 and a 16-byte aligned
    table base, else ``"block"``.  Reads only the table's width and base
    address, so it decides the same on any device."""
    e = table.shape[-1]
    if e % 4 or not 4 <= e <= WARP_MAX_EMBED_DIM or table.data_ptr() % WARP_ALIGN:
        return "block"
    return "warp"


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  mode: str = "mean") -> torch.Tensor:
    """table (V, E) f32, ids (B, L) int32 in [0, V) (clamped), mask (B, L)
    f32 -> (B, E) f32, through the route ``route`` picks."""
    _check(table, ids, mask, mode)
    name = "embedding_bag_warp" if route(table) == "warp" else "embedding_bag"
    return _launch(name, table, ids, mask, mode)


def embedding_bag_block(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                        mode: str = "mean") -> torch.Tensor:
    """The block route, whatever ``route`` would pick."""
    _check(table, ids, mask, mode)
    return _launch("embedding_bag", table, ids, mask, mode)


def embedding_bag_warp(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                       mode: str = "mean") -> torch.Tensor:
    """The warp route; raises on operands it does not take."""
    _check(table, ids, mask, mode)
    if route(table) != "warp":
        raise ValueError(f"embedding_bag_warp: takes E a multiple of 4 up to "
                         f"{WARP_MAX_EMBED_DIM} and a {WARP_ALIGN}-byte aligned table, got "
                         f"{tuple(table.shape)} base {table.data_ptr() % WARP_ALIGN} bytes off")
    return _launch("embedding_bag_warp", table, ids, mask, mode)


def _check(table, ids, mask, mode) -> None:
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


def _launch(name: str, table, ids, mask, mode) -> torch.Tensor:
    """Launch the kernel behind the C entry point ``{name}_launch`` and
    count it under ``name``."""
    v, e = table.shape
    b, l = ids.shape
    out = torch.empty((b, e), dtype=torch.float32, device=table.device)
    lib = build.library()
    with torch.cuda.device(table.device):
        err = getattr(lib, f"{name}_launch")(
            table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
            v, e, b, l, int(mode == "mean"), torch.cuda.current_stream().cuda_stream,
        )
    build.check(name, err)
    build.LAUNCHES.add(name)
    return out

