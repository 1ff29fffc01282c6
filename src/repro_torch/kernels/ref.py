"""Plain PyTorch versions of the slice's CUDA kernels (the bit-exact truth).

Each function computes what its kernel in ``repro_torch/csrc`` computes,
on any device.  The wrappers in ``repro_torch.kernels.ops`` run these on
CPU tensors; ``chip_smoke.py`` holds every kernel against them on the card.
They mirror ``repro.kernels.ref`` of the reference package bit for bit.

Integer hazards of torch (2.x) that shape the code:

  * there is no uint32 ``>>`` or ``%`` on CPU, and ``>>`` on int32 is
    arithmetic, so the hash and every logical shift compute in int64 on
    values masked to their low 32 bits;
  * int64 products that overflow are undefined in C++, so 32-bit
    multiplies split the constant into 16-bit halves (``_mul_lo32``);
  * ``torch.maximum``/``minimum`` canonicalize NaN payloads and order
    -0.0/+0.0 unlike XLA, so the float clamp selects on explicit compares
    of the int32 bit patterns and never materializes a float result.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# fused multi-feature transform op codes (the same values as the
# reference's ``repro.kernels.ref``)
OP_IDENTITY = 0
OP_SIGRID_HASH = 1
OP_POSITIVE_MODULUS = 2
OP_CLAMP = 3
OP_BUCKETIZE = 4
OP_CLAMP_F = 5
OP_BUCKETIZE_F = 6

XOR_KEY32 = 0x5A5A5A5A        # dwrf._XOR_KEY replicated into each byte
NAN_BITS = 0x7FC00000         # float32 quiet-NaN bits (np.full(nan) fill)

_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) lanes -> their unsigned 32-bit value, as int64."""
    return x.to(torch.int64) & _M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a value in [0, 2**32) -> the int32 with those bits."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _mul_lo32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for x in [0, 2**32) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The SigridHash mixer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul_lo32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_lo32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.contiguous().view(torch.float32)


def _clamp_f_bits(ids, p0, p1) -> torch.Tensor:
    """``jnp.clip(bits(ids), bits(p0), bits(p1))`` on bit patterns: a NaN
    upper bound wins, then a NaN value, then a NaN lower bound; +0.0 is
    above -0.0."""
    f, lo, hi = _f32(ids), _f32(p0), _f32(p1)
    up = (f > lo) | ((f == lo) & (ids >= 0))
    m = torch.where(torch.isnan(f), ids,
                    torch.where(torch.isnan(lo), p0, torch.where(up, ids, p0)))
    mf = _f32(m)
    down = (mf < hi) | ((mf == hi) & (m < 0))
    return torch.where(torch.isnan(hi), p1,
                       torch.where(torch.isnan(mf), m, torch.where(down, m, p1)))


def _op_columns(ids, code, p0, p1, borders, present: Sequence[int],
                features_major: bool) -> torch.Tensor:
    """Apply each feature's op; ``code``/``p0``/``p1`` are broadcast
    against ``ids`` and ``borders`` is (features, nb)."""
    out = ids
    if OP_SIGRID_HASH in present:
        h = _hash_u32(_u32(ids) ^ _u32(p0))
        hashed = _i32(h % torch.clamp(_u32(p1), min=1))
        out = torch.where(code == OP_SIGRID_HASH, hashed, out)
    if OP_POSITIVE_MODULUS in present:
        m = torch.clamp(p1.to(torch.int64), min=1)
        out = torch.where(code == OP_POSITIVE_MODULUS,
                          torch.remainder(ids.to(torch.int64), m).to(torch.int32), out)
    if OP_CLAMP in present:
        out = torch.where(code == OP_CLAMP,
                          torch.minimum(torch.maximum(ids, p0), p1), out)
    if OP_BUCKETIZE in present:
        d = _i32(_u32(ids) - _u32(p0)).to(torch.int64)      # int32 wrap
        scale = torch.clamp(p1.to(torch.int64), min=1)
        q = torch.div(d, scale, rounding_mode="floor").clamp(0, 255)
        out = torch.where(code == OP_BUCKETIZE, q.to(torch.int32), out)
    if OP_CLAMP_F in present:
        out = torch.where(code == OP_CLAMP_F, _clamp_f_bits(ids, p0, p1), out)
    if OP_BUCKETIZE_F in present:
        f = _f32(ids)
        cmp = (f[:, :, None] > borders[:, None, :] if features_major
               else f[:, :, None] > borders[None, :, :])
        out = torch.where(code == OP_BUCKETIZE_F,
                          cmp.sum(-1, dtype=torch.int32), out)
    return out.to(torch.int32)


def fused_transform(
    ids: torch.Tensor,        # (rows, features) int32 packed feature matrix
    op_codes: torch.Tensor,   # (features,) int32
    param0: torch.Tensor,     # (features,) int32  (salt / lo / lo-bits)
    param1: torch.Tensor,     # (features,) int32  (max_value / hi / scale)
    borders: Optional[torch.Tensor] = None,   # (features, nb) f32, +inf padded
) -> torch.Tensor:
    """Per-feature op over a packed (rows, features) tile, every candidate
    op computed and selected by code (the shape of the reference oracle)."""
    feats = ids.shape[1]
    if borders is None:
        borders = torch.full((feats, 1), float("inf"), device=ids.device)
    present = tuple(range(OP_IDENTITY, OP_BUCKETIZE_F + 1))
    return _op_columns(ids, op_codes[None, :], param0[None, :], param1[None, :],
                       borders.to(torch.float32), present, features_major=False)


def fused_transform_static(
    ids: torch.Tensor,
    op_codes: Sequence[int],  # per-feature op codes known to the caller
    param0: torch.Tensor,
    param1: torch.Tensor,
    borders: Optional[torch.Tensor] = None,
    features_major: bool = False,     # ids is (features, rows)
) -> torch.Tensor:
    """``fused_transform`` that builds only the ops present in
    ``op_codes``; ``features_major=True`` computes in the engine's packing
    layout with no transposes.  Identical bits to ``fused_transform``."""
    nf = ids.shape[0] if features_major else ids.shape[1]
    ax = (slice(None), None) if features_major else (None, slice(None))
    if borders is None:
        borders = torch.full((nf, 1), float("inf"), device=ids.device)
    code = torch.as_tensor(list(op_codes), dtype=torch.int32, device=ids.device)
    return _op_columns(ids, code[ax], param0[ax], param1[ax],
                       borders.to(torch.float32), set(int(c) for c in op_codes),
                       features_major)


def xor_decrypt(words: torch.Tensor) -> torch.Tensor:
    """(n, 128) int32 stream words -> XOR-decrypted words."""
    return words ^ XOR_KEY32


def dense_unpack(bitmap_words: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Presence-bitmap unpack + dense scatter.

    bitmap_words: (F, W) int32, ``np.packbits`` bytes as LE words;
    values: (F, C) int32, present float32 values as bit patterns.
    Returns (F, W*32) int32 f32 bits, NaN bits where absent.
    """
    feats, w = bitmap_words.shape
    lane = torch.arange(32, dtype=torch.int64, device=bitmap_words.device)
    # packbits is MSB-first per byte; LE words put row 32w+k at bit
    # 8*(k//8) + 7 - (k%8)
    shift = (lane & ~7) + 7 - (lane & 7)
    bits = (_u32(bitmap_words)[:, :, None] >> shift) & 1
    bits = bits.reshape(feats, w * 32)
    rank = torch.cumsum(bits, dim=1) - 1
    idx = rank.clamp(0, values.shape[1] - 1)
    gathered = torch.gather(values, 1, idx)
    nan = torch.tensor(NAN_BITS, dtype=torch.int32, device=values.device)
    return torch.where(bits == 1, gathered, nan)


def ragged_gather(src: torch.Tensor, idx: torch.Tensor,
                  shift: torch.Tensor) -> torch.Tensor:
    """Byte-unaligned word gather: out = src[idx] >>> shift | src[idx+1] <<
    (32-shift), the high part 0 when shift is 0.  src: (S, 128) i32;
    idx/shift: (M, 128) i32; the caller keeps ``idx + 1`` in range."""
    flat = _u32(src.reshape(-1))
    sh = shift.to(torch.int64)
    lo = flat[idx.to(torch.int64)] >> sh
    hi = (flat[idx.to(torch.int64) + 1] << ((32 - sh) & 31)) & _M32
    return _i32(lo | torch.where(sh == 0, torch.zeros_like(hi), hi))
