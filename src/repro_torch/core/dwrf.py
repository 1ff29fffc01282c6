"""DWRF-like columnar file format (forked-ORC stand-in), byte-accurate.

Implements the storage-format co-design of §7.5:

  * **map encoding** (baseline): each stripe stores all features as two
    monolithic map streams (dense / sparse) — readers must fetch and decode
    entire rows even for a tiny feature projection.
  * **feature flattening (FF)**: every feature becomes its own stream(s)
    within the stripe, with a per-stripe stream directory, enabling
    column-selective reads.
  * **feature reordering (FR)**: stream order within a stripe follows a
    supplied popularity order, so coalesced reads over-read less.
  * **large stripes (LS)**: ``stripe_rows`` scales the stripe (and thus the
    contiguous extent of each feature stream).

Streams are compressed (pluggable codec, see below) and XOR-"encrypted"
(a cheap stand-in that still forces a full pass over the bytes — the
paper's datacenter tax).  All sizes are real byte counts; the Tectonic
layer stores the file bytes.

Compression is a codec registry rather than a hard dependency: every
stream carries a 1-byte codec id, ``zstd`` is used when the ``zstandard``
package is importable, and stdlib ``zlib`` is the always-available
fallback, so the format (and the test suite) works in environments
without optional packages installed.
"""
from __future__ import annotations

import dataclasses
import io
import struct
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.schema import ColumnBatch, SparseColumn, TableSchema

_XOR_KEY = 0x5A
_MAGIC = b"DWRF"


def _encrypt(data: bytes) -> bytes:
    return bytes(np.frombuffer(data, np.uint8) ^ _XOR_KEY)


def _decrypt(data: bytes) -> bytes:
    return _encrypt(data)


# ---------------------------------------------------------------------------
# Codec registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Codec:
    cid: int                                   # codec id byte in each stream
    name: str
    compress: Callable[[bytes, int], bytes]    # (payload, level) -> bytes
    decompress: Callable[[bytes], bytes]


_CODECS: Dict[int, Codec] = {}
_CODECS_BY_NAME: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> None:
    if codec.cid in _CODECS and _CODECS[codec.cid].name != codec.name:
        raise ValueError(
            f"codec id {codec.cid} already registered as "
            f"{_CODECS[codec.cid].name!r}"
        )
    if codec.name in _CODECS_BY_NAME and _CODECS_BY_NAME[codec.name].cid != codec.cid:
        raise ValueError(
            f"codec name {codec.name!r} already registered with id "
            f"{_CODECS_BY_NAME[codec.name].cid}"
        )
    _CODECS[codec.cid] = codec
    _CODECS_BY_NAME[codec.name] = codec


register_codec(Codec(cid=0, name="raw",
                     compress=lambda d, level: d,
                     decompress=lambda d: d))
register_codec(Codec(cid=1, name="zlib",
                     compress=lambda d, level: zlib.compress(d, level),
                     decompress=zlib.decompress))

try:
    import zstandard as _zstd
except ImportError:
    _zstd = None
else:
    register_codec(Codec(
        cid=2, name="zstd",
        compress=lambda d, level: _zstd.ZstdCompressor(level=level).compress(d),
        decompress=lambda d: _zstd.ZstdDecompressor().decompress(d),
    ))

DEFAULT_CODEC = "zstd" if _zstd is not None else "zlib"


def available_codecs() -> List[str]:
    return sorted(_CODECS_BY_NAME)


def get_codec(name: Optional[str] = None) -> Codec:
    name = name or DEFAULT_CODEC
    try:
        return _CODECS_BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown codec {name!r}; available: {available_codecs()}"
        ) from None


def encode_stream(payload: bytes, codec: Optional[str] = None, level: int = 1) -> bytes:
    c = get_codec(codec)
    return bytes([c.cid]) + _encrypt(c.compress(payload, level))


def split_stream(data: bytes) -> Tuple[Codec, bytes]:
    """Split a raw stream into (codec, still-encrypted body) without
    touching the bytes — decode engines batch the decrypt pass across
    streams and time decrypt vs decompress separately."""
    cid = data[0]
    codec = _CODECS.get(cid)
    if codec is None:
        raise KeyError(
            f"stream written with unavailable codec id {cid} "
            f"(available: {available_codecs()})"
        )
    return codec, data[1:]


def decode_stream(data: bytes) -> bytes:
    codec, body = split_stream(data)
    return codec.decompress(_decrypt(body))


# ---------------------------------------------------------------------------
# Stream payload (de)serialization
# ---------------------------------------------------------------------------


def _pack_arrays(arrays: Sequence[np.ndarray]) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack("<I", len(arrays)))
    for a in arrays:
        dt = a.dtype.str.encode()
        buf.write(struct.pack("<I", len(dt)))
        buf.write(dt)
        buf.write(struct.pack("<Q", a.nbytes))
        buf.write(a.tobytes())
    return buf.getvalue()


def _unpack_arrays(data: bytes) -> List[np.ndarray]:
    buf = io.BytesIO(data)
    (n,) = struct.unpack("<I", buf.read(4))
    out = []
    for _ in range(n):
        (dl,) = struct.unpack("<I", buf.read(4))
        dt = np.dtype(buf.read(dl).decode())
        (nb,) = struct.unpack("<Q", buf.read(8))
        out.append(np.frombuffer(buf.read(nb), dt))
    return out


_DTYPE_CACHE: Dict[bytes, np.dtype] = {}


def packed_array_headers(data: bytes) -> List[Tuple[np.dtype, int, int]]:
    """Header walk over a ``_pack_arrays`` payload without materializing
    the arrays: [(dtype, data_offset, nbytes), ...].  Data regions are NOT
    word-aligned (dtype strings have odd lengths) — the batched decode
    engine gathers them with per-region shifts."""
    (n,) = struct.unpack_from("<I", data, 0)
    pos = 4
    out: List[Tuple[np.dtype, int, int]] = []
    for _ in range(n):
        (dl,) = struct.unpack_from("<I", data, pos)
        pos += 4
        # bytes() tolerates buffer inputs (ndarray payload views from the
        # batched engine's zero-copy decrypt); the cache keeps the hot
        # per-stream walk from re-parsing the same few dtype strings
        key = bytes(data[pos:pos + dl])
        dt = _DTYPE_CACHE.get(key)
        if dt is None:
            dt = _DTYPE_CACHE[key] = np.dtype(key.decode())
        pos += dl
        (nb,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        out.append((dt, pos, nb))
        pos += nb
    return out


def _dense_payload(col: np.ndarray) -> bytes:
    present = ~np.isnan(col)
    packed = np.packbits(present.astype(np.uint8))
    return _pack_arrays([packed, col[present].astype(np.float32)])


def _dense_unpayload(data: bytes, rows: int) -> np.ndarray:
    packed, vals = _unpack_arrays(data)
    present = np.unpackbits(packed.view(np.uint8), count=rows).astype(bool)
    out = np.full(rows, np.nan, np.float32)
    out[present] = vals.astype(np.float32)
    return out


def _sparse_payload(col: SparseColumn) -> bytes:
    arrays = [col.offsets.astype(np.int64), col.values.astype(np.int64)]
    if col.scores is not None:
        arrays.append(col.scores.astype(np.float32))
    return _pack_arrays(arrays)


def _sparse_unpayload(data: bytes) -> SparseColumn:
    arrays = _unpack_arrays(data)
    return SparseColumn(
        offsets=arrays[0].astype(np.int64),
        values=arrays[1].astype(np.int64),
        scores=arrays[2].astype(np.float32) if len(arrays) > 2 else None,
    )


# sparse_map blob format-version sentinel ("SPM2" as a negative int64 —
# a legacy blob's first array holds non-negative feature ids, so the two
# layouts can never be confused).  v2 stores an explicit per-feature
# scores-presence flag array: the legacy layout inferred presence from
# ``len(scores)``, which collapses a *present-but-empty* scores array
# (a 0-nnz stripe of a scored feature) into ``None`` — diverging from
# the flattened encoding's round-trip.
SPARSE_MAP_V2 = -0x53504D32


def sparse_map_layout(
    arrays: Sequence[np.ndarray],
) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """(fids, scores-present flags or None, index of the first offsets
    array).  Detects the v2 sparse_map layout vs the legacy one (flags
    absent: presence falls back to the lossy emptiness heuristic)."""
    a0 = arrays[0]
    if a0.size == 1 and a0.dtype.kind == "i" and int(a0[0]) == SPARSE_MAP_V2:
        return arrays[1].astype(np.int64), arrays[2].astype(bool), 3
    return a0.astype(np.int64), None, 1


# ---------------------------------------------------------------------------
# File structures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamInfo:
    fid: int                  # -1 for map-encoded monolithic streams
    kind: str                 # dense | sparse | dense_map | sparse_map | labels
    offset: int               # byte offset within the file
    length: int


@dataclasses.dataclass
class StripeInfo:
    row_start: int
    num_rows: int
    offset: int
    length: int
    streams: List[StreamInfo]


@dataclasses.dataclass
class DwrfFooter:
    num_rows: int
    flattened: bool
    stripes: List[StripeInfo]
    feature_order: List[int]

    def stream_index(self) -> Dict[Tuple[int, int], StreamInfo]:
        """(stripe_idx, fid) -> StreamInfo for flattened files."""
        out = {}
        for si, stripe in enumerate(self.stripes):
            for s in stripe.streams:
                out[(si, s.fid)] = s
        return out


@dataclasses.dataclass
class DwrfFile:
    data: bytes
    footer: DwrfFooter

    @property
    def nbytes(self) -> int:
        return len(self.data)


@dataclasses.dataclass(frozen=True)
class DwrfWriterOptions:
    flattened: bool = True               # FF
    stripe_rows: int = 2048              # LS knob
    feature_order: Optional[Sequence[int]] = None   # FR (None = fid order)
    compression_level: int = 1
    codec: Optional[str] = None          # None = DEFAULT_CODEC (zstd if available)


def write_dwrf(batch: ColumnBatch, opts: DwrfWriterOptions) -> DwrfFile:
    """Encode a ColumnBatch into DWRF bytes + footer metadata."""
    buf = io.BytesIO()
    buf.write(_MAGIC)
    stripes: List[StripeInfo] = []

    all_fids = sorted(set(batch.dense) | set(batch.sparse))
    if opts.feature_order is not None:
        order = [f for f in opts.feature_order if f in set(all_fids)]
        order += [f for f in all_fids if f not in set(order)]
    else:
        order = all_fids

    row = 0
    while row < batch.num_rows:
        nrows = min(opts.stripe_rows, batch.num_rows - row)
        part = batch.slice_rows(row, row + nrows)
        stripe_off = buf.tell()
        streams: List[StreamInfo] = []

        def emit(fid: int, kind: str, payload: bytes):
            enc = encode_stream(payload, opts.codec, opts.compression_level)
            streams.append(StreamInfo(fid=fid, kind=kind, offset=buf.tell(), length=len(enc)))
            buf.write(enc)

        if opts.flattened:
            for fid in order:
                if fid in part.dense:
                    emit(fid, "dense", _dense_payload(part.dense[fid]))
                elif fid in part.sparse:
                    emit(fid, "sparse", _sparse_payload(part.sparse[fid]))
        else:
            # map encoding: one monolithic stream per map column type
            dense_blob = _pack_arrays(
                [np.asarray(sorted(part.dense), np.int64)]
                + [part.dense[f] for f in sorted(part.dense)]
            )
            emit(-1, "dense_map", dense_blob)
            sfids = sorted(part.sparse)
            # v2 layout: sentinel, fids, explicit scores-presence flags,
            # then (offsets, values, scores) per feature — a scores-absent
            # feature still ships an empty placeholder array, but the flag
            # (not the length) decides presence on decode
            sparse_parts: List[np.ndarray] = [
                np.asarray([SPARSE_MAP_V2], np.int64),
                np.asarray(sfids, np.int64),
                np.asarray(
                    [int(part.sparse[f].scores is not None) for f in sfids],
                    np.int64,
                ),
            ]
            for f in sfids:
                c = part.sparse[f]
                sparse_parts += [c.offsets, c.values]
                sparse_parts.append(
                    c.scores if c.scores is not None else np.zeros(0, np.float32)
                )
            emit(-1, "sparse_map", _pack_arrays(sparse_parts))

        if part.labels is not None:
            emit(-2, "labels", _pack_arrays([part.labels]))

        stripes.append(
            StripeInfo(
                row_start=row,
                num_rows=nrows,
                offset=stripe_off,
                length=buf.tell() - stripe_off,
                streams=streams,
            )
        )
        row += nrows

    footer = DwrfFooter(
        num_rows=batch.num_rows,
        flattened=opts.flattened,
        stripes=stripes,
        feature_order=list(order),
    )
    return DwrfFile(data=buf.getvalue(), footer=footer)


def concat_dwrf(files: Sequence[DwrfFile]) -> DwrfFile:
    """Byte-concatenate encoded DWRF files into one file whose footer
    indexes every input's stripes (offsets and row ranges rebased).

    This is how multi-source ingestion lands in one partition — e.g. the
    streaming join emitting a labeled head while the tail's labels have
    not arrived yet.  Note the hazard this enables (and which the DPP
    worker must surface as a ``data_error``): the halves may disagree on
    which streams exist per stripe, producing mixed labeled/unlabeled
    stripes inside one file.
    """
    assert files, "concat_dwrf of nothing"
    flattened = files[0].footer.flattened
    assert all(f.footer.flattened == flattened for f in files), (
        "cannot mix flattened and map-encoded files"
    )
    data = bytearray()
    stripes: List[StripeInfo] = []
    row_base = 0
    for f in files:
        byte_base = len(data)
        data.extend(f.data)
        for st in f.footer.stripes:
            stripes.append(
                StripeInfo(
                    row_start=st.row_start + row_base,
                    num_rows=st.num_rows,
                    offset=st.offset + byte_base,
                    length=st.length,
                    streams=[
                        dataclasses.replace(s, offset=s.offset + byte_base)
                        for s in st.streams
                    ],
                )
            )
        row_base += f.footer.num_rows
    footer = DwrfFooter(
        num_rows=row_base,
        flattened=flattened,
        stripes=stripes,
        feature_order=list(files[0].footer.feature_order),
    )
    return DwrfFile(data=bytes(data), footer=footer)


# ---------------------------------------------------------------------------
# Decoding (given raw stream bytes fetched from storage)
# ---------------------------------------------------------------------------


def decode_stripe_features(
    stripe: StripeInfo,
    fetch: Dict[Tuple[int, str], bytes],
    feature_ids: Sequence[int],
) -> ColumnBatch:
    """Decode the requested features of one stripe from fetched stream bytes.

    ``fetch`` maps (fid, kind) -> raw (encrypted+compressed) stream bytes.
    """
    dense: Dict[int, np.ndarray] = {}
    sparse: Dict[int, SparseColumn] = {}
    labels = None
    want = set(feature_ids)

    for s in stripe.streams:
        key = (s.fid, s.kind)
        if key not in fetch:
            continue
        payload = decode_stream(fetch[key])
        if s.kind == "dense":
            if s.fid in want:
                dense[s.fid] = _dense_unpayload(payload, stripe.num_rows)
        elif s.kind == "sparse":
            if s.fid in want:
                sparse[s.fid] = _sparse_unpayload(payload)
        elif s.kind == "labels":
            labels = _unpack_arrays(payload)[0].astype(np.float32)
        elif s.kind == "dense_map":
            arrays = _unpack_arrays(payload)
            fids = arrays[0].astype(np.int64)
            for i, fid in enumerate(fids):
                if fid in want:
                    dense[int(fid)] = arrays[1 + i].astype(np.float32)
        elif s.kind == "sparse_map":
            arrays = _unpack_arrays(payload)
            fids, flags, base = sparse_map_layout(arrays)
            for i, fid in enumerate(fids):
                off = arrays[base + 3 * i].astype(np.int64)
                val = arrays[base + 1 + 3 * i].astype(np.int64)
                sc = arrays[base + 2 + 3 * i]
                has_scores = (
                    bool(flags[i]) if flags is not None else len(sc) > 0
                )
                if fid in want:
                    sparse[int(fid)] = SparseColumn(
                        offsets=off,
                        values=val,
                        scores=sc.astype(np.float32) if has_scores else None,
                    )
    return ColumnBatch(
        num_rows=stripe.num_rows, dense=dense, sparse=sparse, labels=labels
    )
