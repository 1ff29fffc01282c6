"""Pluggable DecodeEngine: batched CUDA execution of stripe decode.

Table 9 (§6.3) splits DPP preprocessing into extract (decrypt +
decompress + column decode), transform, and load; this module batches
extract's decode half.  Mirrors the TransformEngine pattern
(``repro_torch.core.engine``) and the reference's ``repro.core.decode``:

  * ``NumpyDecodeEngine`` — the per-stream reference: exactly the
    behavior ``dwrf.decode_stripe_features`` implements (one XOR pass,
    one decompress, and one unpack/scatter/gather per stream/feature),
    each per-feature numpy call accounted as one kernel launch.
  * ``TorchDecodeEngine`` — the counterpart of the reference's
    ``PallasDecodeEngine``: batches all streams of a stripe into the
    kernels of ``repro_torch.kernels.decode``: ONE launch XOR-decrypts
    every stream's concatenated bytes, ONE launch unpacks every dense
    feature's presence bitmap and scatters its values (features-major
    packing, NaN bits for absent rows), and ONE ragged gather pulls
    every sparse/map array region out of the concatenated payload
    buffer.  Compressed payloads still decompress on host through the
    codec registry — the kernels take over post-decompress.  The
    operands go to the engine's device (``cuda`` unless the caller asks
    for ``cpu``, where the plain PyTorch versions run) and the results
    come back to host numpy.

Both engines produce **byte-identical** ``ColumnBatch``es: the dense
kernel computes entirely in the int32 bit domain (NaN and subnormal
payload values round-trip exactly), the gather kernel is pure byte
movement, and any stream the kernels cannot express bit-exactly —
unexpected payload dtypes, zero-row stripes, labels, malformed presence
bitmaps — is *demoted* to the per-stream reference at run time.

``DecodeStats`` feeds ``WorkerMetrics`` (``extract_fused_s`` /
``extract_fallback_s`` / ``decode_launches``) and carries a
Table-9-style stage split (decrypt / decode / gather / assemble).
"""
from __future__ import annotations

import dataclasses
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import dwrf
from repro_torch.core.schema import ColumnBatch, SparseColumn
from repro_torch.kernels import ops as kops
from repro_torch.obs import counter

_U8 = np.dtype(np.uint8)
_I8 = np.dtype("<i8")
_F4 = np.dtype("<f4")


@dataclasses.dataclass
class DecodeStats:
    """Cumulative per-engine accounting (mirrored into ``WorkerMetrics``)."""

    fused_streams: int = counter()     # streams served by the batched kernels
    fallback_streams: int = counter()  # streams decoded per-stream on host
    demoted_streams: int = counter()   # kernel-eligible streams demoted at run time
    kernel_launches: int = counter()   # fused launches + per-feature host calls
    fused_s: float = counter(0.0)      # extract_s attribution: batched path
    fallback_s: float = counter(0.0)   # extract_s attribution: per-stream path
    # Table-9-style stage split (§6.3): the four sum to ~total decode time
    decrypt_s: float = counter(0.0)    # XOR byte pass
    decode_s: float = counter(0.0)     # decompress + header parse + dense unpack
    gather_s: float = counter(0.0)     # sparse/map array extraction
    assemble_s: float = counter(0.0)   # ColumnBatch construction


def _popcount_prefix(packed: np.ndarray, rows: int) -> int:
    """Popcount of the first ``rows`` presence bits (packbits MSB-first).
    ``int.bit_count`` over the whole prefix is faster than any per-byte
    numpy table walk at the sub-KB sizes presence bitmaps have."""
    full, rem = divmod(rows, 8)
    n = int.from_bytes(packed[:full].tobytes(), "little").bit_count()
    if rem:
        n += (int(packed[full]) & ((0xFF00 >> rem) & 0xFF)).bit_count()
    return n


def _decode_payload(
    kind: str,
    fid: int,
    payload: bytes,
    num_rows: int,
    want: set,
    dense: Dict[int, np.ndarray],
    sparse: Dict[int, SparseColumn],
) -> Tuple[Optional[np.ndarray], int]:
    """Reference per-stream payload decode (the extracted current
    behavior of ``dwrf.decode_stripe_features``).  Returns (labels or
    None, number of per-feature decode calls) — the second drives the
    per-feature launch accounting of the numpy dispatch regime."""
    if kind == "dense":
        if fid in want:
            dense[fid] = dwrf._dense_unpayload(payload, num_rows)
            return None, 1
        return None, 0
    if kind == "sparse":
        if fid in want:
            sparse[fid] = dwrf._sparse_unpayload(payload)
            return None, 1
        return None, 0
    if kind == "labels":
        return dwrf._unpack_arrays(payload)[0].astype(np.float32), 1
    if kind == "dense_map":
        arrays = dwrf._unpack_arrays(payload)
        fids = arrays[0].astype(np.int64)
        n = 0
        for i, f in enumerate(fids):
            if f in want:
                dense[int(f)] = arrays[1 + i].astype(np.float32)
                n += 1
        return None, n
    if kind == "sparse_map":
        arrays = dwrf._unpack_arrays(payload)
        fids, flags, base = dwrf.sparse_map_layout(arrays)
        n = 0
        for i, f in enumerate(fids):
            off = arrays[base + 3 * i].astype(np.int64)
            val = arrays[base + 1 + 3 * i].astype(np.int64)
            sc = arrays[base + 2 + 3 * i]
            has_scores = bool(flags[i]) if flags is not None else len(sc) > 0
            if f in want:
                sparse[int(f)] = SparseColumn(
                    offsets=off,
                    values=val,
                    scores=sc.astype(np.float32) if has_scores else None,
                )
                n += 1
        return None, n
    return None, 0      # unknown stream kind: ignored, like the reference


class DecodeEngine:
    """Decodes one stripe's fetched stream bytes into a ``ColumnBatch``."""

    name = "base"

    def __init__(self):
        self.stats = DecodeStats()

    def decode_stripe(
        self,
        stripe: dwrf.StripeInfo,
        fetch: Dict[Tuple[int, str], bytes],
        feature_ids: Sequence[int],
    ) -> ColumnBatch:
        raise NotImplementedError

    def __call__(self, stripe, fetch, feature_ids) -> ColumnBatch:
        return self.decode_stripe(stripe, fetch, feature_ids)


class NumpyDecodeEngine(DecodeEngine):
    """Per-stream reference decode — one XOR pass + one decompress per
    stream and one unpack/scatter/gather per feature, each accounted as
    one kernel launch (the per-feature dispatch regime of §7.2, applied
    to the extract stage)."""

    name = "numpy"

    def decode_stripe(self, stripe, fetch, feature_ids) -> ColumnBatch:
        st = self.stats
        dense: Dict[int, np.ndarray] = {}
        sparse: Dict[int, SparseColumn] = {}
        labels = None
        want = set(feature_ids)
        for s in stripe.streams:
            key = (s.fid, s.kind)
            if key not in fetch:
                continue
            t0 = time.perf_counter()
            codec, body = dwrf.split_stream(fetch[key])
            plain = dwrf._decrypt(body)
            t1 = time.perf_counter()
            payload = codec.decompress(plain)
            t2 = time.perf_counter()
            lab, n_feats = _decode_payload(
                s.kind, s.fid, payload, stripe.num_rows, want, dense, sparse
            )
            if lab is not None:
                labels = lab
            t3 = time.perf_counter()
            st.decrypt_s += t1 - t0
            if s.kind in ("sparse", "sparse_map"):
                st.decode_s += t2 - t1
                st.gather_s += t3 - t2
            else:
                st.decode_s += t3 - t1
            st.fallback_s += t3 - t0
            st.fallback_streams += 1
            st.kernel_launches += 1 + n_feats
        t4 = time.perf_counter()
        batch = ColumnBatch(
            num_rows=stripe.num_rows, dense=dense, sparse=sparse, labels=labels
        )
        st.assemble_s += time.perf_counter() - t4
        return batch


class TorchDecodeEngine(DecodeEngine):
    """Whole-stripe batched decode via ``kernels.decode``.

    ``device`` is where the three launches run: ``"cuda"`` (the default)
    launches the CUDA kernels and raises where CUDA is missing;
    ``"cpu"`` runs their plain PyTorch versions (how the CPU tests hold
    the engine against the reference).  Both compute identical bits, so
    the engine stays byte-compatible with ``NumpyDecodeEngine``.
    """

    name = "torch"

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchDecodeEngine(device='cuda') needs a CUDA device; "
                "pass device='cpu' to run the plain versions"
            )

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- fused launches -----------------------------------------------------

    def _xor(self, buf: np.ndarray, n: int) -> np.ndarray:
        """One fused decrypt launch over the stripe's concatenated stream
        bytes.  ``buf`` is already padded to whole int32 tiles (byte-wise
        XOR is position-local, so the word view is exact); the return is a
        uint8 view of the kernel output truncated to the real ``n`` bytes —
        every downstream consumer (codec ``decompress``,
        ``packed_array_headers``, ``np.frombuffer``) takes any buffer."""
        words = buf.view("<i4").reshape(-1, 128)
        out = kops.xor_decrypt(self._to_device(words))
        self.stats.kernel_launches += 1
        return out.cpu().numpy().reshape(-1).view(np.uint8)[:n]

    def _dense_launch(
        self, rows: int, bm: np.ndarray, vals_list: List[np.ndarray]
    ) -> List[np.ndarray]:
        """One launch for every dense feature: features-major bitmap words
        (``bm``, already packed (F, 4*words) uint8 by the caller) + value
        bit patterns in, f32 bits (NaN where absent) out."""
        cap = max(max(len(v) for v in vals_list), 1)
        vals = np.zeros((len(vals_list), cap), np.int32)
        for j, v in enumerate(vals_list):
            vals[j, : len(v)] = v
        out = kops.dense_unpack(
            self._to_device(np.ascontiguousarray(bm).view("<i4")),
            self._to_device(vals),
        )
        self.stats.kernel_launches += 1
        res = out.cpu().numpy()
        return [res[j, :rows].view(np.float32) for j in range(len(vals_list))]

    def _gather_launch(
        self,
        pool: List[bytes],
        requests: List[Tuple[int, np.dtype, int, int]],
    ) -> List[np.ndarray]:
        """One launch for every requested array region: splice the
        byte-unaligned regions out of the concatenated payload words."""
        base = np.zeros(len(pool), np.int64)
        pos = 0
        for i, b in enumerate(pool):
            base[i] = pos
            pos += len(b)
        nwords = np.array([-(-nb // 4) for _, _, _, nb in requests], np.int64)
        slots = (nwords + 1) & ~1         # even word slots: 8-byte alignment
        out_off = np.zeros(len(requests) + 1, np.int64)
        np.cumsum(slots, out=out_off[1:])
        total = int(out_off[-1])

        s_rows = max(-(-(-(-pos // 4) + 2) // 128), 1)
        src = np.zeros(s_rows * 512, np.uint8)
        at = 0
        for b in pool:
            src[at: at + len(b)] = (
                b if isinstance(b, np.ndarray) else np.frombuffer(b, np.uint8)
            )
            at += len(b)
        m_rows = max(-(-total // 128), 1)
        idx = np.zeros(m_rows * 128, np.int32)
        shift = np.zeros(m_rows * 128, np.int32)
        if total:
            # vectorized per-lane index build: lane r of request q reads
            # source word start[q]+r with the request's constant bit shift
            ab = base[[pi for pi, _, _, _ in requests]] \
                + np.array([off for _, _, off, _ in requests], np.int64)
            req = np.repeat(np.arange(len(requests)), slots)
            lane = (np.arange(total, dtype=np.int64)
                    - np.repeat(out_off[:-1], slots))
            idx[:total] = ((ab // 4)[req] + lane).astype(np.int32)
            shift[:total] = ((ab % 4) * 8)[req].astype(np.int32)
        out = kops.ragged_gather(
            self._to_device(src.view("<i4").reshape(s_rows, 128)),
            self._to_device(idx.reshape(m_rows, 128)),
            self._to_device(shift.reshape(m_rows, 128)),
        )
        self.stats.kernel_launches += 1
        flat = np.ascontiguousarray(out.cpu().numpy().reshape(-1))
        return [
            np.frombuffer(flat, dt, nb // dt.itemsize, int(out_off[r]) * 4)
            for r, (_, dt, _, nb) in enumerate(requests)
        ]

    # -- stripe decode ------------------------------------------------------

    def decode_stripe(self, stripe, fetch, feature_ids) -> ColumnBatch:
        st = self.stats
        rows = stripe.num_rows
        want = set(feature_ids)
        dense: Dict[int, np.ndarray] = {}
        sparse: Dict[int, SparseColumn] = {}
        labels = None

        # phase 1 — one fused XOR pass over every fetched stream's bytes.
        # Whole streams (codec byte included) go into one preallocated
        # padded buffer so the stripe's bytes are copied exactly once; the
        # codec byte is read from the *original* buffer and its decrypted
        # garbage twin in ``plain`` is simply never referenced (XOR is
        # byte-position-local, so everything after it decrypts exactly).
        t0 = time.perf_counter()
        codecs = dwrf._CODECS
        entries: List[Tuple[dwrf.StreamInfo, dwrf.Codec, int, int]] = []
        parts: List[bytes] = []
        pos = 0
        for s in stripe.streams:
            key = (s.fid, s.kind)
            data = fetch.get(key)
            if data is None:
                continue
            codec = codecs.get(data[0])
            if codec is None:
                dwrf.split_stream(data)      # raises the reference KeyError
            entries.append((s, codec, pos + 1, len(data) - 1))
            parts.append(data)
            pos += len(data)
        if not entries:
            return ColumnBatch(num_rows=rows, dense={}, sparse={}, labels=None)
        buf = np.zeros(pos + (-pos) % 512, np.uint8)
        mv = memoryview(buf)                 # C-level memcpy per stream
        at = 0
        for d in parts:
            ln = len(d)
            mv[at: at + ln] = d
            at += ln
        plain = self._xor(buf, pos)
        t1 = time.perf_counter()
        st.decrypt_s += t1 - t0
        st.fused_s += t1 - t0

        # phase 2 — host decompress + header parse + classification.
        # ``tokens`` records, in stream order, which fids each stream
        # contributes and through which path: the reference inserts dict
        # keys in stream order, so assembly must replay that order even
        # when fused and demoted streams interleave.
        #   ["f", dense_fids, sparse_fids]  — fused stream
        #   ["h", host_job_index]           — host-fallback stream
        dense_jobs: List[list] = []   # [fid, packed, vals, payload, s, tok, oi]
        pool: List[bytes] = []
        requests: List[Tuple[int, np.dtype, int, int]] = []
        dense_sinks: List[Tuple[int, int]] = []              # (fid, req)
        sparse_sinks: List[Tuple[int, int, int, Optional[int]]] = []
        host_jobs: List[list] = []           # [stream_order, StreamInfo, payload]
        tokens: List[list] = []

        def _req(pi: int, hdr: Tuple[np.dtype, int, int]) -> int:
            requests.append((pi, hdr[0], hdr[1], hdr[2]))
            return len(requests) - 1

        t2 = time.perf_counter()
        headers = dwrf.packed_array_headers
        fro = np.frombuffer

        # vectorized prepass: flattened dense streams under the raw codec
        # share one fixed ``_pack_arrays`` header template (only the
        # value-byte count differs), so template match, length check, and
        # presence-bitmap extraction run as whole-stripe numpy gathers
        # instead of per-stream header walks.  Anything that misses the
        # template falls through to the generic per-stream classification
        # below — same decision, slower route.
        fast: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        if rows > 0:
            nb1 = -(-rows // 8)
            head = struct.pack("<II", 2, 3) + b"|u1" + struct.pack("<Q", nb1)
            mid = struct.pack("<I", 3) + b"<f4"
            cands = [
                (oi, start, ln)
                for oi, (s, codec, start, ln) in enumerate(entries)
                if s.kind == "dense" and codec.cid == 0
                and s.fid in want and ln >= 34 + nb1
            ]
            if cands:
                starts = np.array([c[1] for c in cands], np.int64)
                lns = np.array([c[2] for c in cands], np.int64)
                okh = (plain[starts[:, None] + np.arange(19)]
                       == fro(head, np.uint8)).all(1)
                okm = (plain[starts[:, None] + (19 + nb1) + np.arange(7)]
                       == fro(mid, np.uint8)).all(1)
                nb2 = np.ascontiguousarray(
                    plain[starts[:, None] + (26 + nb1) + np.arange(8)]
                ).view("<u8")[:, 0].astype(np.int64)
                ok = okh & okm & (nb2 % 4 == 0) & (lns == 34 + nb1 + nb2)
                if ok.any():
                    sel = np.flatnonzero(ok)
                    bmat = plain[starts[sel, None] + 19 + np.arange(nb1)]
                    for k, ci in enumerate(sel):
                        oi, s0, _ = cands[int(ci)]
                        fast[oi] = (
                            bmat[k],
                            fro(plain, "<i4", int(nb2[ci]) // 4,
                                s0 + 34 + nb1),
                        )

        for oi, (s, codec, start, ln) in enumerate(entries):
            payload = plain[start: start + ln]
            if codec.cid:                     # raw (cid 0) is the identity
                payload = codec.decompress(payload)
            demote = False
            if s.kind == "dense" and s.fid in want:
                fv = fast.get(oi)
                if fv is not None:
                    dense_jobs.append([
                        s.fid, fv[0], fv[1], payload, s, len(tokens), oi,
                    ])
                    tokens.append(["f", [s.fid], ()])
                    continue
                ok = rows > 0
                if ok:
                    hdrs = headers(payload)
                    ok = (
                        len(hdrs) == 2
                        and hdrs[0][0] == _U8 and hdrs[1][0] == _F4
                        and hdrs[1][2] % 4 == 0
                        and hdrs[0][2] * 8 >= rows
                    )
                if ok:
                    # the presence-popcount == len(values) precondition of
                    # the reference scatter is validated vectorized across
                    # all dense jobs after this loop
                    dense_jobs.append([
                        s.fid,
                        fro(payload, np.uint8, hdrs[0][2], hdrs[0][1]),
                        fro(payload, "<i4", hdrs[1][2] // 4, hdrs[1][1]),
                        payload, s, len(tokens), oi,
                    ])
                    tokens.append(["f", [s.fid], ()])
                else:
                    demote = True
            elif s.kind == "sparse" and s.fid in want:
                hdrs = headers(payload)
                ok = (
                    len(hdrs) in (2, 3)
                    and hdrs[0][0] == _I8 and hdrs[1][0] == _I8
                    and (len(hdrs) == 2 or hdrs[2][0] == _F4)
                )
                if ok:
                    pi = len(pool)
                    pool.append(payload)
                    sparse_sinks.append((
                        s.fid, _req(pi, hdrs[0]), _req(pi, hdrs[1]),
                        _req(pi, hdrs[2]) if len(hdrs) == 3 else None,
                    ))
                    tokens.append(["f", (), [s.fid]])
                    st.fused_streams += 1
                else:
                    demote = True
            elif s.kind == "dense_map":
                hdrs = headers(payload)
                ok = len(hdrs) >= 1 and hdrs[0][0] == _I8
                if ok:
                    fids = fro(payload, _I8, hdrs[0][2] // 8, hdrs[0][1])
                    wanted = [
                        (i, int(f)) for i, f in enumerate(fids) if f in want
                    ]
                    ok = len(hdrs) == 1 + len(fids) and all(
                        hdrs[1 + i][0] == _F4 for i, _ in wanted
                    )
                if ok:
                    pi = len(pool)
                    pool.append(payload)
                    for i, f in wanted:
                        dense_sinks.append((f, _req(pi, hdrs[1 + i])))
                    tokens.append(["f", [f for _, f in wanted], ()])
                    st.fused_streams += 1
                else:
                    demote = True
            elif s.kind == "sparse_map":
                hdrs = headers(payload)

                def _meta(i: int) -> np.ndarray:
                    dt, off, nb = hdrs[i]
                    return fro(payload, dt, nb // dt.itemsize, off)

                ok = len(hdrs) >= 1
                wanted = []
                flags = None
                if ok:
                    a0 = _meta(0)
                    v2 = (
                        a0.size == 1 and a0.dtype.kind == "i"
                        and int(a0[0]) == dwrf.SPARSE_MAP_V2
                    )
                    if v2 and len(hdrs) >= 3:
                        fids, flags, base = _meta(1), _meta(2), 3
                    elif not v2:
                        fids, base = a0, 1
                    else:
                        ok = False
                if ok:
                    ok = len(hdrs) == base + 3 * len(fids)
                if ok:
                    wanted = [
                        (i, int(f)) for i, f in enumerate(fids) if f in want
                    ]
                    ok = all(
                        hdrs[base + 3 * i][0] == _I8
                        and hdrs[base + 1 + 3 * i][0] == _I8
                        and hdrs[base + 2 + 3 * i][0] == _F4
                        for i, _ in wanted
                    )
                if ok:
                    pi = len(pool)
                    pool.append(payload)
                    for i, f in wanted:
                        has_scores = (
                            bool(flags[i]) if flags is not None
                            else hdrs[base + 2 + 3 * i][2] > 0
                        )
                        sparse_sinks.append((
                            f,
                            _req(pi, hdrs[base + 3 * i]),
                            _req(pi, hdrs[base + 1 + 3 * i]),
                            _req(pi, hdrs[base + 2 + 3 * i])
                            if has_scores else None,
                        ))
                    tokens.append(["f", (), [f for _, f in wanted]])
                    st.fused_streams += 1
                else:
                    demote = True
            elif s.kind == "labels":
                tokens.append(["h", len(host_jobs)])
                host_jobs.append([oi, s, payload])
                continue
            else:
                # unwanted flattened streams / unknown kinds: decompressed
                # (like the reference) with nothing left to batch
                st.fused_streams += 1
                continue
            if demote:
                st.demoted_streams += 1
                tokens.append(["h", len(host_jobs)])
                host_jobs.append([oi, s, payload])

        # vectorized precondition check over all dense jobs: the reference
        # scatter needs popcount(presence[:rows]) == len(values) per
        # feature — violations demote to host, which raises the reference
        # error at that stream's position.  Dense jobs only count toward
        # fused_streams once they survive this check (counters are
        # monotonic; no increment-then-undo).
        if dense_jobs:
            nb = -(-rows // 8)
            nw4 = ((nb + 3) // 4) * 4
            bm = np.zeros((len(dense_jobs), nw4), np.uint8)
            for j, job in enumerate(dense_jobs):
                bm[j, :nb] = job[1][:nb]
            pops = np.unpackbits(bm[:, :nb], axis=1, count=rows).sum(
                axis=1, dtype=np.int64
            )
            bad = [
                j for j, job in enumerate(dense_jobs)
                if int(pops[j]) != len(job[2])
            ]
            if bad:
                for j in bad:
                    fid, _, _, payload, s, ti, oi = dense_jobs[j]
                    st.demoted_streams += 1
                    tokens[ti] = ["h", len(host_jobs)]
                    host_jobs.append([oi, s, payload])
                keep = [
                    j for j in range(len(dense_jobs)) if j not in set(bad)
                ]
                dense_jobs = [dense_jobs[j] for j in keep]
                bm = bm[keep]
            st.fused_streams += len(dense_jobs)
        t3 = time.perf_counter()
        st.decode_s += t3 - t2
        st.fused_s += t3 - t2

        # phase 3 — the two batched launches
        if dense_jobs:
            t4 = time.perf_counter()
            cols = self._dense_launch(rows, bm, [j[2] for j in dense_jobs])
            for job, col in zip(dense_jobs, cols):
                dense[job[0]] = col
            dt = time.perf_counter() - t4
            st.decode_s += dt
            st.fused_s += dt
        if requests:
            t5 = time.perf_counter()
            arrs = self._gather_launch(pool, requests)
            for fid, ri in dense_sinks:
                dense[fid] = arrs[ri]
            for fid, oi, vi, si in sparse_sinks:
                sparse[fid] = SparseColumn(
                    offsets=arrs[oi], values=arrs[vi],
                    scores=arrs[si] if si is not None else None,
                )
            dt = time.perf_counter() - t5
            st.gather_s += dt
            st.fused_s += dt

        # phase 4 — per-stream host fallback (labels + demoted streams),
        # processed in stream order so any reference error raises at the
        # same stream the per-stream path would reach first.  Raw-codec
        # payloads are still views of the decrypt output here; the
        # reference decoder wants real bytes (``io.BytesIO`` reads).
        added: List[Optional[Tuple[List[int], List[int]]]] = \
            [None] * len(host_jobs)
        for ji in sorted(range(len(host_jobs)),
                         key=lambda i: host_jobs[i][0]):
            _, s, payload = host_jobs[ji]
            t6 = time.perf_counter()
            if not isinstance(payload, bytes):
                payload = bytes(payload)
            before_d, before_s = set(dense), set(sparse)
            lab, n_feats = _decode_payload(
                s.kind, s.fid, payload, rows, want, dense, sparse
            )
            if lab is not None:
                labels = lab
            added[ji] = (
                [f for f in dense if f not in before_d],
                [f for f in sparse if f not in before_s],
            )
            dt = time.perf_counter() - t6
            if s.kind in ("sparse", "sparse_map"):
                st.gather_s += dt
            else:
                st.decode_s += dt
            st.fallback_s += dt
            st.fallback_streams += 1
            st.kernel_launches += n_feats

        # phase 5 — assemble by replaying the reference's stream-order
        # dict insertion from the tokens
        t7 = time.perf_counter()
        dense_order: List[int] = []
        sparse_order: List[int] = []
        for tok in tokens:
            if tok[0] == "f":
                dense_order += tok[1]
                sparse_order += tok[2]
            else:
                a = added[tok[1]]
                if a is not None:
                    dense_order += a[0]
                    sparse_order += a[1]
        batch = ColumnBatch(
            num_rows=rows,
            dense={f: dense[f] for f in dense_order if f in dense},
            sparse={f: sparse[f] for f in sparse_order if f in sparse},
            labels=labels,
        )
        dt = time.perf_counter() - t7
        st.assemble_s += dt
        st.fused_s += dt
        return batch


DECODE_ENGINES = {"numpy": NumpyDecodeEngine, "torch": TorchDecodeEngine}


def make_decode_engine(
    engine: Union[str, DecodeEngine, None],
    device: Union[str, torch.device] = "cuda",
) -> DecodeEngine:
    """Resolve a decode-engine choice (name, instance, or factory) for one
    exclusive owner (engines accumulate stats; don't share instances
    across readers).  ``device`` places a ``"torch"`` engine."""
    if engine is None:
        return NumpyDecodeEngine()
    if isinstance(engine, DecodeEngine):
        return engine
    if isinstance(engine, str):
        try:
            cls = DECODE_ENGINES[engine]
        except KeyError:
            raise ValueError(
                f"unknown decode engine {engine!r}; "
                f"expected one of {sorted(DECODE_ENGINES)}"
            ) from None
        return cls(device) if cls is TorchDecodeEngine else cls()
    return engine()      # factory callable
