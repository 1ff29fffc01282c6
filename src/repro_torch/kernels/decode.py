"""CUDA kernels for batched stripe decode (``csrc/decode.cu``).

Counterparts of the reference's Pallas ``repro.kernels.decode``: one
launch XOR-decrypts a stripe's concatenated stream bytes, one unpacks
every dense feature's presence bitmap and scatters its values, and one
splices every byte-unaligned sparse/map array region out of the payload
words.  ``repro_torch.core.decode.TorchDecodeEngine`` packs the operands.

``dense_unpack`` and ``ragged_gather`` each have two kernels; a route
function picks one from the operands before the launch:

* ``dense_unpack_route``: ``"warp"`` for 1 to 32 bitmap words a feature
  (stripes of up to 1,024 rows: every stripe the engine decodes): a block
  of 8 W threads a feature, each warp scanning the bitmap words with
  shuffles itself, 4 rows a thread in one 16-byte store (counted as
  ``dense_unpack_warp``); ``"block"`` for wider bitmaps, a scan across a
  256-thread block in chunks (counted as ``dense_unpack``).
* ``ragged_gather_route``: ``"vec"`` for contiguous idx and shift with
  8-byte aligned bases and an even count (every (M, 128) operand the
  engine builds), two outputs a thread, a pair of consecutive indices at
  one shift spliced from 3 source words (counted as
  ``ragged_gather_vec``); ``"scalar"`` for anything else, one output a
  thread (counted as ``ragged_gather``).

The rules are a dispatch on the operands, not a fallback: a call that a
new route takes raises if that kernel fails to build or launch.
``dense_unpack_warp``/``dense_unpack_block`` and
``ragged_gather_vec``/``ragged_gather_scalar`` launch one route each (the
new routes raise on operands they do not take), so the two can be timed
on the same operands.  Every route gives the plain version's bits.

Each wrapper takes CUDA tensors only, checks them, allocates the output,
launches on the current stream and counts the launch in
``build.LAUNCHES``; the plain versions live in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

UNPACK_WARP_MAX_WORDS = 32   # the warp route: one bitmap word a lane of each warp
GATHER_VEC_LANE = 2          # int32 outputs a thread of the vec route: one 8-byte store
GATHER_VEC_ALIGN = 8         # bytes: the vec route's idx and shift base alignment


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _int32_cuda(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def xor_decrypt(words: torch.Tensor) -> torch.Tensor:
    """(n, 128) int32 stream words -> XOR-decrypted words."""
    _int32_cuda("xor_decrypt words", words, 2)
    if words.shape[1] != 128:
        raise ValueError(f"xor_decrypt: expected (n, 128) words, got {tuple(words.shape)}")
    if words.data_ptr() % 16:
        raise ValueError("xor_decrypt: words must be 16-byte aligned")
    out = torch.empty_like(words)
    lib = build.library()
    with torch.cuda.device(words.device):
        err = lib.xor_decrypt_launch(words.data_ptr(), out.data_ptr(),
                                     words.numel(), _stream())
    build.check("xor_decrypt", err)
    build.LAUNCHES.add("xor_decrypt")
    return out


def dense_unpack_route(bitmap_words: torch.Tensor) -> str:
    """``"warp"`` for 1 to 32 bitmap words a feature, else ``"block"``.
    Reads only the bitmap's width (one word a lane of a warp), so it
    decides the same on any device; the value row's width C does not
    matter."""
    return "warp" if 1 <= bitmap_words.shape[-1] <= UNPACK_WARP_MAX_WORDS else "block"


def ragged_gather_route(idx: torch.Tensor, shift: torch.Tensor) -> str:
    """``"vec"`` for contiguous idx and shift whose bases are 8-byte
    aligned and whose element count is even, else ``"scalar"``.
    Reads only the layout, sizes and base addresses, so it decides the
    same on any device (the output is a fresh, aligned allocation)."""
    for t in (idx, shift):
        if not t.is_contiguous() or t.data_ptr() % GATHER_VEC_ALIGN:
            return "scalar"
    return "scalar" if idx.numel() % GATHER_VEC_LANE else "vec"


def dense_unpack(bitmap_words: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(F, W) int32 bitmap words + (F, C) int32 value bits -> (F, W*32)
    int32 f32 bits, NaN bits where absent, through the route
    ``dense_unpack_route`` picks."""
    _check_unpack(bitmap_words, values)
    if dense_unpack_route(bitmap_words) == "warp":
        return _launch_unpack("dense_unpack_warp", bitmap_words, values)
    return _launch_unpack("dense_unpack", bitmap_words, values)


def dense_unpack_block(bitmap_words: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The block route, whatever ``dense_unpack_route`` would pick."""
    _check_unpack(bitmap_words, values)
    return _launch_unpack("dense_unpack", bitmap_words, values)


def dense_unpack_warp(bitmap_words: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The warp route; raises on operands it does not take."""
    _check_unpack(bitmap_words, values)
    if dense_unpack_route(bitmap_words) != "warp":
        raise ValueError(f"dense_unpack_warp: takes 1 to {UNPACK_WARP_MAX_WORDS} bitmap words "
                         f"a feature, got {tuple(bitmap_words.shape)}")
    return _launch_unpack("dense_unpack_warp", bitmap_words, values)


def _check_unpack(bitmap_words: torch.Tensor, values: torch.Tensor) -> None:
    _int32_cuda("dense_unpack bitmap_words", bitmap_words, 2)
    _int32_cuda("dense_unpack values", values, 2)
    feats, w = bitmap_words.shape
    if values.shape[0] != feats or values.shape[1] < 1:
        raise ValueError(
            f"dense_unpack: values {tuple(values.shape)} must be (F={feats}, C>=1)"
        )
    if values.device != bitmap_words.device:
        raise ValueError("dense_unpack: operands on different devices")
    if feats * w * 32 >= 2 ** 31 or values.numel() >= 2 ** 31:
        raise ValueError("dense_unpack: operands too large for int32 indexing")


def _launch_unpack(name: str, bitmap_words: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    feats, w = bitmap_words.shape
    # a fresh allocation: 16-byte aligned, as the warp route's stores need
    out = torch.empty((feats, w * 32), dtype=torch.int32, device=bitmap_words.device)
    lib = build.library()
    with torch.cuda.device(bitmap_words.device):
        err = getattr(lib, f"{name}_launch")(
            bitmap_words.data_ptr(), values.data_ptr(), out.data_ptr(), feats, w,
            values.shape[1], _stream(),
        )
    build.check(name, err)
    build.LAUNCHES.add(name)
    return out


def ragged_gather(src: torch.Tensor, idx: torch.Tensor,
                  shift: torch.Tensor) -> torch.Tensor:
    """out = src[idx] >>> shift | src[idx+1] << (32-shift), shift in
    {0, 8, 16, 24}.  src (S, 128), idx and shift (M, 128), all int32;
    through the route ``ragged_gather_route`` picks."""
    _check_gather(src, idx, shift)
    if ragged_gather_route(idx, shift) == "vec":
        return _launch_gather("ragged_gather_vec", src, idx, shift)
    return _launch_gather("ragged_gather", src, idx, shift)


def ragged_gather_scalar(src: torch.Tensor, idx: torch.Tensor,
                         shift: torch.Tensor) -> torch.Tensor:
    """The scalar route, whatever ``ragged_gather_route`` would pick."""
    _check_gather(src, idx, shift)
    return _launch_gather("ragged_gather", src, idx, shift)


def ragged_gather_vec(src: torch.Tensor, idx: torch.Tensor,
                      shift: torch.Tensor) -> torch.Tensor:
    """The vec route; raises on operands it does not take."""
    _check_gather(src, idx, shift)
    if ragged_gather_route(idx, shift) != "vec":
        raise ValueError(
            f"ragged_gather_vec: takes {GATHER_VEC_ALIGN}-byte aligned idx and shift of an "
            f"even count, got {tuple(idx.shape)} with bases "
            f"{idx.data_ptr() % GATHER_VEC_ALIGN} and {shift.data_ptr() % GATHER_VEC_ALIGN} "
            "bytes off"
        )
    return _launch_gather("ragged_gather_vec", src, idx, shift)


def _check_gather(src: torch.Tensor, idx: torch.Tensor, shift: torch.Tensor) -> None:
    _int32_cuda("ragged_gather src", src, 2)
    _int32_cuda("ragged_gather idx", idx, 2)
    _int32_cuda("ragged_gather shift", shift, 2)
    if idx.shape != shift.shape:
        raise ValueError(
            f"ragged_gather: idx {tuple(idx.shape)} != shift {tuple(shift.shape)}"
        )
    if not (src.device == idx.device == shift.device):
        raise ValueError("ragged_gather: operands on different devices")


def _launch_gather(name: str, src: torch.Tensor, idx: torch.Tensor,
                   shift: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(idx)          # a fresh allocation: 16-byte aligned
    lib = build.library()
    with torch.cuda.device(src.device):
        err = getattr(lib, f"{name}_launch")(
            src.data_ptr(), idx.data_ptr(), shift.data_ptr(), out.data_ptr(),
            src.numel(), idx.numel(), _stream(),
        )
    build.check(name, err)
    build.LAUNCHES.add(name)
    return out
