"""The msgpack subset a checkpoint shard is written in.

The reference packs each shard with ``msgpack.packb(payload,
use_bin_type=True)``: one map from a leaf's path to ``{"dtype": str,
"shape": [int, ...], "data": bytes}``.  The port writes and reads that
format itself, so it needs no ``msgpack`` package.  It covers exactly
the types such a payload holds, each in the smallest form ``packb``
picks:

- map (fixmap, map16, map32) with str keys;
- str (fixstr, str8, str16, str32), UTF-8;
- bin (bin8, bin16, bin32) from ``bytes``, ``bytearray`` or a
  ``memoryview``;
- int (positive and negative fixint, uint8-64, int8-64);
- array (fixarray, array16, array32) from a ``list``.

Anything else raises ``TypeError`` (``bool`` too, which is an ``int`` to
Python but not to msgpack), and so does an int outside [-2^63, 2^64)
(``OverflowError``) or a bin or str of 2^32 bytes or more
(``ValueError``).  ``pack`` writes a bin's buffer to the file as it is,
so a shard of gigabytes is never held twice; ``unpackb`` returns each
bin as a ``memoryview`` into the buffer it was given, and the caller
copies out what it keeps.
"""
from __future__ import annotations

import io
import struct
from typing import Any, BinaryIO, Tuple

_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">{c}") for c in "bhiq")


def _sized(write, n: int, fix_tag: int, fix_max: int, tags: Tuple[int, int, int],
           what: str) -> None:
    """The header of a str, bin, array or map of ``n`` items or bytes:
    the fix form below ``fix_max`` (none if 0), else the 8-, 16- or 32-bit
    length form (``tags``; 8-bit may be absent, None)."""
    if n < fix_max:
        write(bytes((fix_tag | n,)))
    elif tags[0] is not None and n < 1 << 8:
        write(bytes((tags[0], n)))
    elif n < 1 << 16:
        write(bytes((tags[1],)) + _U16.pack(n))
    elif n < 1 << 32:
        write(bytes((tags[2],)) + _U32.pack(n))
    else:
        raise ValueError(f"msgpack cannot hold a {what} of {n} (2^32 or more)")


def _pack_int(write, x: int) -> None:
    if 0 <= x < 1 << 7:
        write(bytes((x,)))
    elif -32 <= x < 0:
        write(_I8.pack(x))                   # negative fixint: 0xe0 | low bits
    elif x >= 0:
        for tag, s, bits in ((0xcc, _U8, 8), (0xcd, _U16, 16), (0xce, _U32, 32),
                             (0xcf, _U64, 64)):
            if x < 1 << bits:
                write(bytes((tag,)) + s.pack(x))
                return
        raise OverflowError(f"int {x} does not fit msgpack's uint64")
    else:
        for tag, s, bits in ((0xd0, _I8, 8), (0xd1, _I16, 16), (0xd2, _I32, 32),
                             (0xd3, _I64, 64)):
            if x >= -(1 << (bits - 1)):
                write(bytes((tag,)) + s.pack(x))
                return
        raise OverflowError(f"int {x} does not fit msgpack's int64")


def pack(obj: Any, f: BinaryIO) -> None:
    """Write ``obj`` to ``f`` as ``msgpack.packb(obj, use_bin_type=True)``
    would, bins from their own buffers."""
    write = f.write
    t = type(obj)
    if t is dict:
        _sized(write, len(obj), 0x80, 16, (None, 0xde, 0xdf), "map")
        for k, v in obj.items():
            if type(k) is not str:
                raise TypeError(f"map key {k!r}: only str keys are packed")
            pack(k, f)
            pack(v, f)
    elif t is str:
        b = obj.encode("utf-8")
        _sized(write, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb), "str")
        write(b)
    elif t is bytes or t is bytearray or t is memoryview:
        m = memoryview(obj).cast("B") if t is memoryview else obj
        _sized(write, len(m), 0, 0, (0xc4, 0xc5, 0xc6), "bin")
        write(m)
    elif t is int:
        _pack_int(write, obj)
    elif t is list:
        _sized(write, len(obj), 0x90, 16, (None, 0xdc, 0xdd), "array")
        for v in obj:
            pack(v, f)
    else:
        raise TypeError(f"cannot pack {t.__name__}: not in the checkpoint's msgpack subset")


def packb(obj: Any) -> bytes:
    """``pack`` into bytes."""
    f = io.BytesIO()
    pack(obj, f)
    return f.getvalue()


class _Reader:
    def __init__(self, buf):
        self.m = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.m):
            raise ValueError(f"msgpack data truncated at byte {self.pos} "
                             f"({n} wanted, {len(self.m) - self.pos} left)")
        out = self.m[self.pos:end]
        self.pos = end
        return out

    def num(self, s: struct.Struct) -> int:
        return s.unpack(self.take(s.size))[0]

    def obj(self) -> Any:
        tag = self.num(_U8)
        if tag < 0x80:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if tag < 0x90:
            return self.map(tag & 0x0f)
        if tag < 0xa0:
            return self.array(tag & 0x0f)
        if tag < 0xc0:
            return self.str(tag & 0x1f)
        lengths = {0xc4: _U8, 0xc5: _U16, 0xc6: _U32}
        if tag in lengths:
            return self.take(self.num(lengths[tag]))
        ints = {0xcc: _U8, 0xcd: _U16, 0xce: _U32, 0xcf: _U64,
                0xd0: _I8, 0xd1: _I16, 0xd2: _I32, 0xd3: _I64}
        if tag in ints:
            return self.num(ints[tag])
        strs = {0xd9: _U8, 0xda: _U16, 0xdb: _U32}
        if tag in strs:
            return self.str(self.num(strs[tag]))
        if tag in (0xdc, 0xdd):
            return self.array(self.num(_U16 if tag == 0xdc else _U32))
        if tag in (0xde, 0xdf):
            return self.map(self.num(_U16 if tag == 0xde else _U32))
        raise ValueError(f"msgpack type byte 0x{tag:02x} at byte {self.pos - 1} is "
                         "not in the checkpoint's msgpack subset")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if type(k) is not str:
                raise ValueError(f"map key of type {type(k).__name__}: only str keys "
                                 "are read")
            out[k] = self.obj()
        return out


def unpackb(buf) -> Any:
    """Read one object that fills ``buf`` (bytes-like).  Bins come back as
    ``memoryview``s into ``buf``."""
    r = _Reader(buf)
    out = r.obj()
    if r.pos != len(r.m):
        raise ValueError(f"{len(r.m) - r.pos} bytes after the msgpack object")
    return out
