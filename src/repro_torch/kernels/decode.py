"""CUDA kernels for batched stripe decode (``csrc/decode.cu``).

Counterparts of the reference's Pallas ``repro.kernels.decode``: one
launch XOR-decrypts a stripe's concatenated stream bytes, one unpacks
every dense feature's presence bitmap and scatters its values, and one
splices every byte-unaligned sparse/map array region out of the payload
words.  ``repro_torch.core.decode.TorchDecodeEngine`` packs the operands.

Each wrapper takes CUDA tensors only, checks them, allocates the output,
launches on the current stream and counts the launch in
``build.LAUNCHES``; the plain versions live in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


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


def dense_unpack(bitmap_words: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(F, W) int32 bitmap words + (F, C) int32 value bits -> (F, W*32)
    int32 f32 bits, NaN bits where absent."""
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
    out = torch.empty((feats, w * 32), dtype=torch.int32, device=bitmap_words.device)
    lib = build.library()
    with torch.cuda.device(bitmap_words.device):
        err = lib.dense_unpack_launch(bitmap_words.data_ptr(), values.data_ptr(),
                                      out.data_ptr(), feats, w, values.shape[1],
                                      _stream())
    build.check("dense_unpack", err)
    build.LAUNCHES.add("dense_unpack")
    return out


def ragged_gather(src: torch.Tensor, idx: torch.Tensor,
                  shift: torch.Tensor) -> torch.Tensor:
    """out = src[idx] >>> shift | src[idx+1] << (32-shift), shift in
    {0, 8, 16, 24}.  src (S, 128), idx and shift (M, 128), all int32."""
    _int32_cuda("ragged_gather src", src, 2)
    _int32_cuda("ragged_gather idx", idx, 2)
    _int32_cuda("ragged_gather shift", shift, 2)
    if idx.shape != shift.shape:
        raise ValueError(
            f"ragged_gather: idx {tuple(idx.shape)} != shift {tuple(shift.shape)}"
        )
    if not (src.device == idx.device == shift.device):
        raise ValueError("ragged_gather: operands on different devices")
    out = torch.empty_like(idx)
    lib = build.library()
    with torch.cuda.device(src.device):
        err = lib.ragged_gather_launch(src.data_ptr(), idx.data_ptr(),
                                       shift.data_ptr(), out.data_ptr(),
                                       src.numel(), idx.numel(), _stream())
    build.check("ragged_gather", err)
    build.LAUNCHES.add("ragged_gather")
    return out
