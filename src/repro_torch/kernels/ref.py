"""Plain PyTorch versions of the port's CUDA kernels (the truth they are held to).

Each function computes what its kernel in ``repro_torch/csrc`` computes,
on any device.  The wrappers in ``repro_torch.kernels.ops`` run these on
CPU tensors; ``chip_smoke.py`` holds every kernel against them on the card.
They mirror ``repro.kernels.ref`` of the reference package bit for bit,
except ``flash_attention`` and ``ssd_scan``, whose reference oracles and
kernels agree only within a stated tolerance, and ``rowwise_adagrad_``,
the reference model's table update, which no TPU kernel computes.

Integer hazards of torch (2.x) that shape the code:

  * there is no uint32 ``>>`` or ``%`` on CPU, and ``>>`` on int32 is
    arithmetic, so the hash and every logical shift compute in int64 on
    values masked to their low 32 bits;
  * int64 products that overflow are undefined in C++, so 32-bit
    multiplies split the constant into 16-bit halves (``_mul_lo32``);
  * ``torch.maximum``/``minimum`` canonicalize NaN payloads and order
    -0.0/+0.0 unlike XLA, so the float clamp selects on explicit compares
    of the int32 bit patterns and never materializes a float result;
  * a float sum over an axis (``.sum(dim)``) takes its own order, so
    ``embedding_bag`` adds its slots one at a time, as its kernel does.
"""
from __future__ import annotations

import math
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


def check_hash_args(salt: int, max_value: int) -> None:
    """The reference takes salt and max_value as ``jnp.uint32``, which
    refuses values outside [0, 2**32); a modulus of 0 is refused too."""
    if not 0 <= int(salt) <= _M32:
        raise ValueError(f"sigrid_hash: salt {salt} not in [0, 2**32)")
    if not 0 < int(max_value) <= _M32:
        raise ValueError(f"sigrid_hash: max_value {max_value} not in [1, 2**32)")


def sigrid_hash(ids: torch.Tensor, salt: int, max_value: int) -> torch.Tensor:
    """int32 ids (any shape) -> ``hash(ids ^ salt) % max_value`` in uint32,
    reinterpreted as int32 (values of 2**31 and up wrap negative, as the
    reference's ``astype(int32)`` does)."""
    check_hash_args(salt, max_value)
    return _i32(_hash_u32(_u32(ids) ^ int(salt)) % int(max_value))


def bucketize(values: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    """The count of borders strictly below each value, compared in float32:
    values (any shape), borders (nb,) -> int32.  A count, not a search, so
    it holds for unsorted borders too; NaN compares false either way."""
    v = values.to(torch.float32)
    return (v[..., None] > borders.to(torch.float32)).sum(-1, dtype=torch.int32)


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
    # a fill on the device, not a host-to-device copy of the constant
    return torch.where(bits == 1, gathered, torch.full_like(gathered, NAN_BITS))


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


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  mode: str = "mean") -> torch.Tensor:
    """Pooled bags in the TPU kernel's order: for l = 0..L-1 in turn,
    ``out += table[ids[:, l]] * mask[:, l]`` and ``denom += mask[:, l]``
    (every slot, masked ones too), then in "mean" mode ``out / max(denom,
    1)`` with a NaN denom kept.  Each product and sum is its own op, so
    nothing fuses into an FMA.  table (V, E) f32, ids (B, L) int, clamped
    to [0, V-1]; mask (B, L) f32 -> (B, E) f32."""
    if mode not in ("mean", "sum"):
        raise ValueError(f"mode must be 'mean' or 'sum', got {mode!r}")
    rows = ids.to(torch.int64).clamp(0, table.shape[0] - 1)
    b, l = ids.shape
    out = torch.zeros((b, table.shape[1]), dtype=torch.float32, device=table.device)
    denom = torch.zeros((b, 1), dtype=torch.float32, device=table.device)
    for j in range(l):
        w = mask[:, j:j + 1]
        out = out + table[rows[:, j]] * w
        denom = denom + w
    if mode == "mean":
        out = out / torch.maximum(denom, torch.ones_like(denom))
    return out


@torch.no_grad()
def rowwise_adagrad_(table: torch.Tensor, acc: torch.Tensor, keys: torch.Tensor,
                     weights: torch.Tensor, grad: torch.Tensor, lr, eps: float = 1e-8):
    """Row-wise AdaGrad in place on (R, E) rows and their (R,)
    accumulator, in the reference's form (``repro.models.dlrm``'s
    ``sparse_table_update``, whose scatter-adds have no TPU kernel): the
    occurrence (m, l) names row ``keys[m, l]`` (none where it is
    negative) with gradient ``weights[m, l] * grad[m]``; every
    occurrence's mean squared gradient is added to its accumulator entry
    first (duplicates included), then each occurrence moves its row by
    -lr/sqrt(acc+eps) times its gradient.  keys and weights (M, L), grad
    (M, E).  Returns (table, acc)."""
    l = keys.shape[1]
    keep = (keys.reshape(-1) >= 0).nonzero().squeeze(1)
    rows = keys.reshape(-1)[keep].long()
    rg = grad[keep // l] * weights.reshape(-1)[keep][:, None]
    acc.index_add_(0, rows, torch.mean(torch.square(rg), dim=-1))
    scale = lr / torch.sqrt(acc[rows] + eps)
    table.index_add_(0, rows, (-scale[:, None] * rg).to(table.dtype))
    return table, acc


MASK_VALUE = -2.0e38          # masked scores: the TPU kernel's NEG_INF, not -inf


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention, the reference's ``ref.flash_attention``: q (B, H,
    S, D), k and v (B, KVH, T, D) with H % KVH == 0 (query head h reads KV
    head h // (H/KVH), expanded by ``repeat_interleave``) -> (B, H, S, D).
    Scores ``q.k`` in the inputs' type, then float32 divided by sqrt(D)
    (or times ``scale`` when one is given);
    causal masking (positions from 0) at -2e38; float32 softmax cast to
    the inputs' type before P.V."""
    d = q.shape[-1]
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    # sqrt(D) correctly rounded to float32, as jnp.sqrt(d) gives it; a
    # Python scalar, so no host-to-device copy
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
    sc = sc / math.sqrt(d) if scale is None else sc * scale
    if causal:
        s, t = q.shape[2], k.shape[2]
        pos = torch.arange(max(s, t), device=q.device)
        sc = torch.where(pos[:s, None] >= pos[None, :t], sc, MASK_VALUE)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_: torch.Tensor,
             c_: torch.Tensor, initial_state: Optional[torch.Tensor] = None):
    """The SSD recurrence, one position at a time in float32, in the
    model's layout: x (B, S, H, P), dt (B, S, H), a (H,) or (B, H), b_ and
    c_ (B, S, G, N) with head h reading group h // (H/G).  For t in order,
    ``state = exp(dt_t a) state + dt_t x_t B_t^T`` and ``y_t = state C_t``;
    returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N)
    float32, from ``initial_state`` or zero.  Groups broadcast over their
    heads: nothing is expanded."""
    bsz, s, h, p = x.shape
    g, n = b_.shape[2], b_.shape[3]
    hg = h // g
    f32 = torch.float32
    a = a.to(f32).expand(bsz, h)
    xf, dtf, bf, cf = (t.to(f32) for t in (x, dt, b_, c_))
    if initial_state is None:
        state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    else:
        state = initial_state.to(f32).clone(memory_format=torch.contiguous_format)
    ys = torch.empty((bsz, s, h, p), dtype=f32, device=x.device)
    for t in range(s):
        da = torch.exp(dtf[:, t] * a)                                   # (B, H)
        dx = (xf[:, t] * dtf[:, t, :, None]).reshape(bsz, g, hg, p, 1)
        state = (state * da[:, :, None, None]).view(bsz, g, hg, p, n) + \
            dx * bf[:, t].reshape(bsz, g, 1, 1, n)
        ys[:, t] = (state.view(bsz, g, hg * p, n) @ cf[:, t, :, :, None]).view(bsz, h, p)
        state = state.view(bsz, h, p, n)
    return ys.to(x.dtype), state


def ssd_chunk_forward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b_: torch.Tensor, c_: torch.Tensor):
    """The reference's ``ref.ssd_chunk_forward`` in the TPU kernel's
    layout: x (BH, S, P), dt (BH, S), a (BH,), b_ and c_ (BH, S, N) ->
    y (BH, S, P) in x's dtype, from a zero state, and the final state
    (BH, N, P) float32, which the TPU kernel does not return.  It is
    ``ssd_scan`` with one head and one group per row."""
    y, state = ssd_scan(x[:, :, None], dt[:, :, None], a[:, None], b_[:, :, None],
                        c_[:, :, None])
    y = y[:, :, 0]
    return y, state[:, 0].transpose(-1, -2)
