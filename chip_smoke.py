#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` (timed).
3. Captures the data path's kernel operands from one stripe of the
   full-width ``dlrm-paper`` data path, holds each kernel bit-exact
   (``torch.equal``) against its plain PyTorch version on the card, and
   times kernel, plain version and, where one exists, the single PyTorch
   call computing the same function (device time from torch.profiler,
   call time from CUDA events).  Then holds each kernel bit-exact on
   adversarial inputs the main path never makes (NaN payloads, signed
   zeros, subnormals, extreme parameters, both tile layouts, long bitmaps,
   every byte shift; for ``embedding_bag`` empty bags, duplicate ids, the
   last row, fractional weights, odd L and E, NaN/inf rows under a mask of
   0, subnormal rows, a table of more than 2^31 elements).
4. The serving path: serves every batch of the full-width ``dlrm-paper``
   DPP session through ``dlrm_dpp_batches(CONFIG, 512, device="cuda")``
   with the launch counts set to 0 just before, checks that every data
   path kernel launched, that the batches have the expected shapes and
   finite dense values, and that they are byte-identical (as a multiset:
   workers race) to the port's numpy-engine session on the same data;
   prints batches/s and rows/s.
5. The trainer path: with the launch counts set to 0, serves the
   ``dlrm-paper`` session with its one cut (vocab 200,000 per table instead
   of 2,000,000: the store's host tier is numpy on the host) and trains 8
   steps of the tiered-store DLRM on its batches with ``Trainer(...,
   device="cuda")`` and ``kernel_bags=True``; checks that
   ``embedding_bag`` launched, that every loss is finite, and that the
   same loop on the CPU (same batches, same tables) gives every step's
   loss within rtol 1e-4.  Prints per-step times, steps/s, rows/s, the
   hot rate and the device idle share of a profiled run, then holds
   ``embedding_bag`` bit-exact against its plain version at the operands of
   that run's first fully-hot lookup and times it (and
   ``torch.nn.functional.embedding_bag`` as the library yardstick).
6. Prints one JSON line with every kernel's numbers, the card's line, and
   last the result line ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full float32 (TF32 is switched off for
both matmul and cuDNN).

Any failure raises, so the script exits nonzero and prints no result.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BATCH = 512
# the trainer path's one cut: the store's host tier is numpy on the host,
# 43 GB at 2M rows per table; the card's work is the same at either vocab
TRAIN_VOCAB = 200_000
TRAIN_STEPS = 8
HOT_ROWS = 1024


def _setup():
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch not found beside this script")
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    return torch, card


def _digest(batch) -> str:
    import numpy as np

    h = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(batch[k])
        h.update(f"{k}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _call_ms(torch, fn, iters: int = 200) -> float:
    """Time per call of back-to-back calls, CUDA events around the run:
    what a caller pays, launch and host overhead included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(torch, prof) -> float:
    """Device time (us) of every kernel and copy a profiler run recorded."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == cuda)


def _device_ms(torch, fn, iters: int = 50) -> float:
    """Device time per call (kernels and copies that the call runs, summed),
    from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = _device_us(torch, prof)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / iters / 1e3


def _capture_operands(torch):
    """Every kernel's operands as the main path builds them for its first
    stripe (partition 0, rows [0, 512))."""
    import numpy as np

    from repro_torch.core.decode import TorchDecodeEngine
    from repro_torch.core.engine import TorchEngine
    from repro_torch.core.reader import TableReader
    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.launch.train import dlrm_dpp_table

    class CaptureDecode(TorchDecodeEngine):
        def __init__(self):
            super().__init__("cuda")
            self.operands = {}
            self._kernel = None

        def _to_device(self, a):
            t = super()._to_device(a)
            self.operands.setdefault(self._kernel, []).append(t.clone())
            return t

        def _xor(self, buf, n):
            self._kernel = "xor_decrypt"
            return super()._xor(buf, n)

        def _dense_launch(self, rows, bm, vals_list):
            self._kernel = "dense_unpack"
            return super()._dense_launch(rows, bm, vals_list)

        def _gather_launch(self, pool, requests):
            self._kernel = "ragged_gather"
            return super()._gather_launch(pool, requests)

    class CaptureTransform(TorchEngine):
        def __init__(self, pipeline):
            super().__init__(pipeline, "cuda")
            self.waves = []

        def _launch(self, mat, codes, p0, p1, borders):
            self.waves.append(tuple(
                torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in (mat, codes, p0, p1, borders)
            ))
            return super()._launch(mat, codes, p0, p1, borders)

    table, spec = dlrm_dpp_table(CONFIG, BATCH)
    decode = CaptureDecode()
    reader = TableReader(table, list(spec.feature_ids), record_popularity=False,
                         decode_engine=decode)
    meta = table.partitions[0]
    stripe = next(reader.iter_stripes(meta, 0, BATCH))
    transform = CaptureTransform(spec.pipeline())
    transform.run(stripe.batch)
    if sorted(decode.operands) != ["dense_unpack", "ragged_gather", "xor_decrypt"]:
        raise RuntimeError(f"decode captured {sorted(decode.operands)}")
    if len(transform.waves) != 2:
        raise RuntimeError(f"expected 2 transform waves, captured {len(transform.waves)}")
    return decode.operands, transform.waves


def _kernel_checks(torch, operands, waves):
    """Bit-exactness and times of each kernel against its plain version."""
    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import fused_transform as kft
    from repro_torch.kernels import ref

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # bounds: bytes count each input read once and each output written
    # once; operations count ~12 integer ops per hashed, clamped or
    # bucketized element and one compare per border for BUCKETIZE_F

    cases = []
    (words,) = operands["xor_decrypt"]
    cases.append(dict(
        name="xor_decrypt", source="src/repro_torch/csrc/decode.cu",
        replaces="src/repro/kernels/decode.py:49",
        kernel=lambda: kdecode.xor_decrypt(words), plain=lambda: ref.xor_decrypt(words),
        library=lambda: torch.bitwise_xor(words, ref.XOR_KEY32),
        bytes=2 * nbytes(words), ops=words.numel(),
        shape=f"words {tuple(words.shape)}",
    ))
    bm, vals = operands["dense_unpack"]
    out_elems = bm.shape[0] * bm.shape[1] * 32
    cases.append(dict(
        name="dense_unpack", source="src/repro_torch/csrc/decode.cu",
        replaces="src/repro/kernels/decode.py:87",
        kernel=lambda: kdecode.dense_unpack(bm, vals),
        plain=lambda: ref.dense_unpack(bm, vals), library=None,
        bytes=nbytes(bm, vals) + 4 * out_elems, ops=6 * out_elems,
        shape=f"bitmap {tuple(bm.shape)} values {tuple(vals.shape)}",
    ))
    src, idx, sh = operands["ragged_gather"]
    cases.append(dict(
        name="ragged_gather", source="src/repro_torch/csrc/decode.cu",
        replaces="src/repro/kernels/decode.py:125",
        kernel=lambda: kdecode.ragged_gather(src, idx, sh),
        plain=lambda: ref.ragged_gather(src, idx, sh), library=None,
        bytes=nbytes(src, idx, sh) + nbytes(idx), ops=4 * idx.numel(),
        shape=f"src {tuple(src.shape)} idx {tuple(idx.shape)}",
    ))
    for w, (mat, codes, p0, p1, brd) in enumerate(waves):
        present = sorted(set(codes.tolist()))
        cases.append(dict(
            name="fused_transform", wave=w,
            source="src/repro_torch/csrc/fused_transform.cu",
            replaces="src/repro/kernels/fused_transform.py:81",
            kernel=(lambda mat=mat, codes=codes, p0=p0, p1=p1, brd=brd:
                    kft.fused_transform(mat, codes, p0, p1, brd, features_major=True)),
            plain=(lambda mat=mat, codes=codes, p0=p0, p1=p1, brd=brd:
                   ref.fused_transform(mat.T, codes, p0, p1, brd).T),
            library=None,
            bytes=2 * nbytes(mat) + nbytes(codes, p0, p1, brd),
            ops=mat.shape[1] * sum(
                (brd.shape[1] if c == ref.OP_BUCKETIZE_F else 12)
                for c in codes.tolist()
            ),
            shape=f"tile {tuple(mat.shape)} nb {brd.shape[1]} codes {present}",
        ))

    rows = []
    for c in cases:
        got = c["kernel"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            raise RuntimeError(f"{c['name']}: kernel disagrees with its plain version")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        if c["library"] is not None and not torch.equal(c["library"](), want):
            raise RuntimeError(f"{c['name']}: library call disagrees with the plain version")
        ms = _device_ms(torch, c["kernel"])
        plain_ms = _device_ms(torch, c["plain"], iters=10)
        library_ms = _device_ms(torch, c["library"]) if c["library"] else None
        call_ms = _call_ms(torch, c["kernel"])
        plain_call_ms = _call_ms(torch, c["plain"], iters=20)
        library_call_ms = _call_ms(torch, c["library"]) if c["library"] else None
        bytes_ms = c["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = c["ops"] / FP32_OPS_PER_S * 1e3
        rows.append(dict(
            name=c["name"], wave=c.get("wave"), shape=c["shape"],
            route="cuda", source=c["source"], replaces=c["replaces"],
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms, call_ms=call_ms, plain_call_ms=plain_call_ms,
            library_call_ms=library_call_ms,
        ))
        print(f"[kernel] {c['name']}{'' if c.get('wave') is None else ' wave ' + str(c['wave'])}"
              f" {c['shape']}: bit-exact, kernel_ms={ms:.6f} plain_ms={plain_ms:.6f}"
              f" library_ms={library_ms} bound_ms={max(bytes_ms, ops_ms):.6f}"
              f" call_ms={call_ms:.6f} plain_call_ms={plain_call_ms:.6f}"
              f" library_call_ms={library_call_ms}", flush=True)
    # one entry per kernel: fused_transform's two waves (both launched for
    # every stripe) add up, and keep their own numbers under "waves"
    results = []
    for r in rows:
        same = [q for q in results if q["name"] == r["name"]]
        if not same:
            results.append(dict(r, waves=[dict(r)] if r["wave"] is not None else None))
            continue
        q = same[0]
        for k in ("ms", "plain_ms", "bound_ms", "call_ms", "plain_call_ms"):
            q[k] += r[k]
        q["max_abs_err"] = max(q["max_abs_err"], r["max_abs_err"])
        q["shape"] += "; " + r["shape"]
        q["waves"].append(dict(r))
    for q in results:
        q.pop("wave")
        if q["waves"] is None:
            q.pop("waves")
    return results


def _adversarial_checks(torch) -> None:
    """Each kernel against its plain version on inputs the main path never
    makes: every op code with NaN payloads, signed zeros, subnormals and
    extreme parameters in both tile layouts, bitmaps of many 256-word
    chunks with too few values, every byte shift, odd sizes."""
    import numpy as np

    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import fused_transform as kft
    from repro_torch.kernels import ref

    i32 = (-(2 ** 31), 2 ** 31 - 1)
    bits = lambda v: int(np.float32(v).view(np.int32))
    cuda = lambda a, dt=torch.int32: torch.from_numpy(np.ascontiguousarray(a)).to(
        device="cuda", dtype=dt)

    def lanes(rng, n, floats):
        if floats:
            v = (rng.standard_normal(n) * 100).astype(np.float32).view(np.int32).copy()
            special = [bits(x) for x in (np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                                         1e-40, -1e-42)] + [0x7FC00001, 0x7F800001]
        else:
            v = rng.integers(*i32, n, dtype=np.int64).astype(np.int32)
            special = [i32[0], i32[1], 0, -1]
        special = np.array(special, np.int64).astype(np.int32)
        k = min(n, 3 * len(special))
        v[rng.choice(n, k, replace=False)] = np.resize(special, k)
        return v

    params = {
        ref.OP_IDENTITY: [(0, 0)],
        ref.OP_SIGRID_HASH: [(7, 33), (i32[1], i32[1] - 1), (0, 0), (-5, -1)],
        ref.OP_POSITIVE_MODULUS: [(0, 13), (0, i32[1]), (0, 0), (0, -7)],
        ref.OP_CLAMP: [(-50, 50), (50, -50), i32],
        ref.OP_BUCKETIZE: [(-100, 10), (i32[1], 1), (i32[0], 3), (5, 0), (5, -9)],
        ref.OP_CLAMP_F: [(bits(a), bits(b)) for a, b in (
            (-1.0, 1.0), (1.0, -1.0), (-0.0, 0.0), (0.0, -0.0), (np.nan, 2.0),
            (-2.0, np.nan), (1e-40, 1.0))],
        ref.OP_BUCKETIZE_F: [(0, 0)] * 3,
        9: [(0, 0)],                       # unknown codes pass through
    }
    for rows in (37, 70_000):
        rng = np.random.default_rng(rows)
        cols, codes, p0, p1, brd = [], [], [], [], []
        for code, pl in params.items():
            for a, b in pl:
                cols.append(lanes(rng, rows, code in (ref.OP_CLAMP_F, ref.OP_BUCKETIZE_F)))
                codes.append(code)
                p0.append(a)
                p1.append(b)
                k = int(rng.integers(1, 18))
                row = np.full(17, np.inf, np.float32)
                row[:k] = np.sort(rng.standard_normal(k) * 50)
                brd.append(row)
        mat, c, a, b = cuda(np.stack(cols)), cuda(codes), cuda(p0), cuda(p1)
        bd = cuda(np.stack(brd), torch.float32)
        rm = mat.T.contiguous()
        for got, want in (
            (kft.fused_transform(mat, c, a, b, bd, features_major=True),
             ref.fused_transform(rm, c, a, b, bd).T),
            (kft.fused_transform(rm, c, a, b, bd), ref.fused_transform(rm, c, a, b, bd)),
            (kft.fused_transform(rm, c, a, b), ref.fused_transform(rm, c, a, b)),
        ):
            if not torch.equal(got, want):
                raise RuntimeError(f"fused_transform: adversarial tile of {rows} rows differs")
        print(f"[adversarial] fused_transform {tuple(mat.shape)} every op, both "
              "layouts: bit-exact", flush=True)

    rng = np.random.default_rng(1)
    for n in (1, 40_000):
        w = cuda(rng.integers(*i32, (n, 128), dtype=np.int64).astype(np.int32))
        if not torch.equal(kdecode.xor_decrypt(w), ref.xor_decrypt(w)):
            raise RuntimeError(f"xor_decrypt: ({n}, 128) differs")
    print("[adversarial] xor_decrypt (1, 128) and (40000, 128): bit-exact", flush=True)

    for rows, feats in ((1, 3), (40_000, 7)):
        nw = -(-rows // 32)
        bitmap = np.zeros((feats, nw), np.int32)
        values = np.zeros((feats, rows), np.int32)
        for f in range(feats):
            present = rng.random(rows) < (0.0, 0.3, 1.0, 0.5, 0.9, 0.7, 0.05)[f]
            buf = np.zeros(nw * 4, np.uint8)
            packed = np.packbits(present.astype(np.uint8))
            buf[: len(packed)] = packed
            bitmap[f] = buf.view("<i4")
            n = int(present.sum()) // (2 if f % 2 else 1)    # some too few values
            values[f, :n] = lanes(rng, max(n, 1), True)[:n]
        bm, vals = cuda(bitmap), cuda(values)
        for v in (vals, vals[:, :3].contiguous()):          # ranks clip to C-1
            if not torch.equal(kdecode.dense_unpack(bm, v), ref.dense_unpack(bm, v)):
                raise RuntimeError(f"dense_unpack: {rows} rows x {feats} differs")
    print("[adversarial] dense_unpack up to 1250 words x 7 features: bit-exact",
          flush=True)

    for m in (1, 20_000):
        n = max(m, 2) * 128
        src = cuda(rng.integers(*i32, (n // 128, 128), dtype=np.int64).astype(np.int32))
        idx = rng.integers(0, n - 1, (m, 128)).astype(np.int32)
        sh = rng.choice(np.array([0, 8, 16, 24], np.int32), (m, 128))
        idx.flat[0], sh.flat[0] = n - 2, 24                 # the last word pair
        idx, sh = cuda(idx), cuda(sh)
        if not torch.equal(kdecode.ragged_gather(src, idx, sh),
                           ref.ragged_gather(src, idx, sh)):
            raise RuntimeError(f"ragged_gather: ({m}, 128) differs")
    print("[adversarial] ragged_gather every shift: bit-exact", flush=True)


def _serve(torch, engine: str, profile: bool = False):
    """Serve every batch of the full-width session; returns the batches,
    the session, setup and serve seconds, and (profiled) device seconds."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.launch.train import dlrm_dpp_batches

    t0 = time.perf_counter()
    batches, session = dlrm_dpp_batches(
        CONFIG, BATCH, device="cuda", engine=engine, decode_engine=engine,
    )
    t1 = time.perf_counter()
    out = []
    t_last = t1
    prof = (profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profile else None)
    if prof is not None:
        prof.start()
    for b in batches:
        out.append(b)
        t_last = time.perf_counter()
    device_s = None
    if prof is not None:
        torch.cuda.synchronize()
        prof.stop()
        device_s = _device_us(torch, prof) / 1e6
    if session.state != "COMPLETED":
        raise RuntimeError(f"{engine} session ended {session.state}")
    m = session.worker_metrics()
    stages = {k: getattr(m, k) for k in (
        "extract_s", "transform_s", "load_s", "extract_fused_s",
        "extract_fallback_s", "transform_fused_s", "transform_fallback_s",
        "kernel_launches", "decode_launches", "fused_features",
        "fallback_features", "splits_done",
    )}
    serve_s = t_last - t1
    rows = sum(len(b["label"]) for b in out)
    print(f"[serve] {engine}: {len(out)} batches, setup {t1 - t0:.3f} s, serve "
          f"{serve_s:.3f} s, {len(out) / serve_s:.3f} batches/s, "
          f"{rows / serve_s:.1f} rows/s, workers {len(session.workers)}"
          + (f", device busy {device_s:.6f} s, idle share {1 - device_s / serve_s:.4f}"
             if device_s is not None else "")
          + f", stages {json.dumps(stages)}", flush=True)
    return out, session, serve_s, device_s


def _bits_equal(torch, a, b) -> bool:
    """Bit-for-bit equality of two float32 tensors (NaN payloads and signed
    zeros included, which ``torch.equal`` would not tell apart)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def _bag_adversarial_checks(torch) -> None:
    """``embedding_bag`` against its plain version on bags the main path
    never makes: empty bags, duplicate ids, the last row, fractional
    weights, L and E that are not multiples of 32 (E=16 is dlrm-smoke's),
    L longer than a shared-memory chunk, NaN and inf rows under a mask of 0,
    a NaN mask, subnormal rows, ids out of range (clamped) and a table of
    more than 2^31 elements (int64 offsets)."""
    import numpy as np

    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import ref

    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def check(name, table, ids, mask):
        out = {}
        for mode in ("mean", "sum"):
            got = kbag.embedding_bag(table, ids, mask, mode=mode)
            want = ref.embedding_bag(table, ids, mask, mode=mode)
            torch.cuda.synchronize()
            if not _bits_equal(torch, got, want):
                raise RuntimeError(f"embedding_bag ({mode}): {name} differs from the "
                                   "plain version")
            out[mode] = got
        return out

    rng = np.random.default_rng(12)
    for v, e, b, l in ((7, 1, 5, 3), (50, 16, 9, 8), (300, 40, 64, 33),
                       (1000, 128, 100, 300), (64, 1000, 8, 5), (10, 128, 4, 0)):
        table = rng.standard_normal((v, e)).astype(np.float32)
        ids = rng.integers(0, v, (b, l)).astype(np.int32)
        mask = (rng.random((b, l)) < 0.6).astype(np.float32)
        if l:
            mask[: b // 3] *= rng.random((b // 3, l)).astype(np.float32) * 3   # fractional
            mask[-1] = 0.0                                                   # an empty bag
            ids[-2] = ids[-2, 0]                                             # duplicates
            ids[0, 0] = v - 1                                                # the last row
            ids[1, 0], ids[2, -1] = -3, v + 5                                # clamped
        out = check(f"(V={v}, E={e}, B={b}, L={l})", cuda(table), cuda(ids), cuda(mask))
        empty = out["sum"][-1:] if l else out["sum"]
        if not torch.equal(empty, torch.zeros_like(empty)):
            raise RuntimeError("embedding_bag: an empty bag is not 0")
    print("[adversarial] embedding_bag E in (1, 16, 40, 128, 1000), L up to 300, "
          "empty/duplicate/last-row/clamped/fractional: bit-exact", flush=True)

    table = np.array([[1, 2, 3, 4], [np.nan, np.inf, -np.inf, 1],
                      [1e-40, -1e-42, 3e-39, 5]], np.float32)
    ids = np.array([[0, 1], [2, 2], [1, 1], [0, 2], [2, 0]], np.int32)
    mask = np.array([[1, 0], [1, 0], [0, 0], [np.nan, 1], [1, 0]], np.float32)
    out = check("NaN/inf/subnormal rows", cuda(table), cuda(ids), cuda(mask))["sum"].cpu()
    if not (torch.isnan(out[0, :3]).all() and torch.isnan(out[2, :3]).all()
            and torch.isnan(out[3]).all()):
        raise RuntimeError("embedding_bag: NaN/inf rows under a mask of 0 must give NaN")
    if not torch.equal(out[1].view(torch.int32), torch.from_numpy(table[2]).view(torch.int32)):
        raise RuntimeError("embedding_bag: subnormal rows were flushed")
    print("[adversarial] embedding_bag NaN/inf rows under mask 0 -> NaN, NaN mask, "
          "subnormals kept: bit-exact", flush=True)

    e = 128
    v = 2 ** 31 // e + 4096                       # more than 2^31 elements
    big = torch.zeros((v, e), dtype=torch.float32, device="cuda")
    big[-4096:] = torch.randn((4096, e), device="cuda")
    ids = cuda(rng.integers(v - 4096, v, (64, 8)).astype(np.int32))
    mask = cuda((rng.random((64, 8)) < 0.7).astype(np.float32))
    check(f"table ({v}, {e})", big, ids, mask)
    del big
    torch.cuda.empty_cache()
    print(f"[adversarial] embedding_bag table ({v}, {e}) = {v * e} elements: bit-exact",
          flush=True)


def _train_run(torch, cfg, batches, tables, device, store_cls=None, profile=False):
    """Train ``TRAIN_STEPS`` steps of the tiered-store DLRM on the recorded
    batches; returns the trainer, its store, the wall seconds and (when
    profiled) the profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import TieredEmbeddingStore, Trainer, TrainerConfig

    store = (store_cls or TieredEmbeddingStore)(
        tables, HOT_ROWS, admit_reads=2, device=device)
    trainer = Trainer(
        cfg,
        OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=TRAIN_STEPS),
        TrainerConfig(max_steps=TRAIN_STEPS, kernel_bags=True, trace_stall=False),
        embedding_store=store, device=device,
    )
    prof = (profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profile else None)
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    state = trainer.fit(iter(batches))
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    if state["step"] != TRAIN_STEPS:
        raise RuntimeError(f"{device} trainer took {state['step']} steps, "
                           f"expected {TRAIN_STEPS}")
    losses = [m.loss for m in trainer.history]
    print(f"[train] {device}: {TRAIN_STEPS} steps in {wall:.3f} s, "
          f"{TRAIN_STEPS / wall:.4f} steps/s, {TRAIN_STEPS * BATCH / wall:.1f} rows/s, "
          f"hot_rate {store.stats.hot_rate:.4f}, kernel_bags {store.stats.kernel_bags}, "
          f"losses {losses}", flush=True)
    for m in trainer.history:
        print(f"[train] {device} step {m.step}: loss {m.loss:.6f} embed_fetch_s "
              f"{m.embed_fetch_s:.4f} step_time_s {m.step_time_s:.4f} stall_s "
              f"{m.stall_s:.6f} hot_rate {m.hot_rate:.4f}", flush=True)
    return trainer, store, wall, prof


def _train_path(torch):
    """The trainer path: serve the cut-vocab dlrm-paper session on the card,
    train on its batches on the card and on the CPU, profile a third run;
    returns the main run's launch counts and the kernel operands of the
    profiled run's first fully-hot lookup."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.kernels import build
    from repro_torch.launch.train import dlrm_dpp_batches
    from repro_torch.train import TieredEmbeddingStore, init_tables

    cfg = dataclasses.replace(CONFIG, vocab_per_table=TRAIN_VOCAB)
    t = time.perf_counter()
    tables = init_tables(cfg, seed=3)
    print(f"[train] tables {tables.shape} f32 ({tables.nbytes / 1e9:.2f} GB) drawn in "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    # the main path: counts set to 0 just before, read just after
    build.LAUNCHES.reset()
    t = time.perf_counter()
    gen, session = dlrm_dpp_batches(cfg, BATCH, device="cuda")
    batches = list(gen)
    if session.state != "COMPLETED" or len(batches) != TRAIN_STEPS:
        raise RuntimeError(f"session {session.state} served {len(batches)} batches")
    print(f"[train] served {len(batches)} batches of the vocab-{TRAIN_VOCAB} session in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    for b in batches:
        if b["sparse_ids"].max() >= TRAIN_VOCAB or b["sparse_ids"].min() < 0:
            raise RuntimeError("served ids outside the cut vocab")
    live = np.mean([b["sparse_mask"].sum() for b in batches])
    trainer, store, gpu_s, _ = _train_run(torch, cfg, batches, tables, "cuda")
    launches = build.LAUNCHES.snapshot()
    print(f"[train] main path launches {launches}", flush=True)
    if launches.get("embedding_bag", 0) <= 0 or store.stats.kernel_bags <= 0:
        raise RuntimeError("the trainer path never launched embedding_bag")
    gpu_hist = trainer.history
    gpu_losses = np.array([m.loss for m in gpu_hist])
    if not np.isfinite(gpu_losses).all():
        raise RuntimeError(f"non-finite losses {gpu_losses}")
    stats = {k: getattr(store.stats, k) for k in (
        "lookups", "hot_hits", "dram_fetches", "kernel_bags", "admitted", "evicted",
        "refreshed", "hot_rows")}
    del trainer, store

    cpu_trainer, cpu_store, cpu_s, _ = _train_run(torch, cfg, batches, tables, "cpu")
    cpu_losses = np.array([m.loss for m in cpu_trainer.history])
    rel = np.abs(cpu_losses - gpu_losses) / np.abs(cpu_losses)
    if not np.allclose(gpu_losses, cpu_losses, rtol=1e-4, atol=0):
        raise RuntimeError(f"card losses {gpu_losses} vs CPU losses {cpu_losses}")
    print(f"[train] card vs CPU loss: max rel diff {rel.max():.3e} (rtol 1e-4)", flush=True)
    del cpu_trainer, cpu_store

    class TimedStore(TieredEmbeddingStore):
        """Host seconds of the store's phases, and the operands of the first
        kernel launch (copied on the host, so the profile holds no extra
        device work)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.seconds = {"pooled": 0.0, "bag_launch": 0.0, "apply_sparse_update": 0.0}
            self.operands = None

        def _timed(self, name, fn, *a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.seconds[name] += time.perf_counter() - t0
            return out

        def pooled(self, *a, **k):
            return self._timed("pooled", super().pooled, *a, **k)

        def apply_sparse_update(self, *a, **k):
            return self._timed("apply_sparse_update", super().apply_sparse_update, *a, **k)

        def _bag_launch(self, table, ids, mask):
            if self.operands is None:
                self.operands = (table.copy(), ids.copy(), mask.copy())
            return self._timed("bag_launch", super()._bag_launch, table, ids, mask)

    trainer, store, prof_s, prof = _train_run(torch, cfg, batches, tables, "cuda",
                                              store_cls=TimedStore, profile=True)
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == cuda and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total
    busy_s = sum(by_name.values()) / 1e6
    copy_s = sum(v for k, v in by_name.items() if "memcpy" in k.lower()) / 1e6
    bag_s = sum(v for k, v in by_name.items() if "embedding_bag" in k) / 1e6
    step_s = sum(m.step_time_s for m in trainer.history)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({"train": {
        "config": cfg.name, "vocab_per_table": TRAIN_VOCAB, "batch": BATCH,
        "steps": TRAIN_STEPS, "hot_rows_per_table": HOT_ROWS,
        "live_ids_per_batch": float(live),
        "card_s": gpu_s, "cpu_s": cpu_s, "profiled_card_s": prof_s,
        "card_steps_per_s": TRAIN_STEPS / gpu_s, "card_rows_per_s": TRAIN_STEPS * BATCH / gpu_s,
        "card_losses": gpu_losses.tolist(), "cpu_losses": cpu_losses.tolist(),
        "max_rel_loss_diff": float(rel.max()),
        "card_step_metrics": [dataclasses.asdict(m) for m in gpu_hist],
        "store_stats": stats, "hot_rate": gpu_hist[-1].hot_rate,
        "profiled_host_s": dict(store.seconds, embed_fetch=sum(
            m.embed_fetch_s for m in trainer.history), step_time=step_s,
            mlp_step=step_s - store.seconds["apply_sparse_update"]),
        "device_busy_s": busy_s, "device_copy_s": copy_s,
        "device_embedding_bag_s": bag_s, "device_idle_share": 1 - busy_s / prof_s,
        "device_top_us": dict(top),
    }}), flush=True)
    operands = store.operands
    del trainer, store
    return launches, operands


def _bag_checks(torch, operands):
    """``embedding_bag`` at the operands of the trainer's first fully-hot
    lookup: bit-exact against its plain version in both modes, times of
    kernel, plain version and ``torch.nn.functional.embedding_bag``."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import ref

    table, ids, mask = (torch.from_numpy(a).cuda() for a in operands)
    for mode in ("mean", "sum"):
        got = kbag.embedding_bag(table, ids, mask, mode=mode)
        want = ref.embedding_bag(table, ids, mask, mode=mode)
        torch.cuda.synchronize()
        if not _bits_equal(torch, got, want):
            raise RuntimeError(f"embedding_bag ({mode}): kernel disagrees with its plain "
                               "version at the main path's shapes")
    err = float((got - want).abs().max().item())
    ids64 = ids.long()
    denom = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
    kernel = lambda: kbag.embedding_bag(table, ids, mask, mode="mean")
    plain = lambda: ref.embedding_bag(table, ids, mask, mode="mean")
    library = lambda: F.embedding_bag(ids64, table, mode="sum",
                                      per_sample_weights=mask) / denom
    want = plain()
    if not torch.allclose(library(), want, rtol=1e-5, atol=1e-6):
        raise RuntimeError("F.embedding_bag disagrees with the plain version")
    b, l = ids.shape
    e = table.shape[1]
    # the launch reads only the rows its ids name (every slot is read,
    # masked ones too), plus ids and mask, and writes the (b, e) output
    rows = int(torch.unique(ids).numel())
    nbytes = rows * e * table.element_size() + sum(
        t.numel() * t.element_size() for t in (ids, mask)) + 4 * b * e
    flops = 2 * b * l * e
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_OPS_PER_S * 1e3
    row = dict(
        name="embedding_bag", route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:40",
        shape=f"table {tuple(table.shape)} ids/mask {tuple(ids.shape)} "
              f"fully-hot bags {b} rows read {rows}",
        max_abs_err=err, ms=_device_ms(torch, kernel), plain_ms=_device_ms(torch, plain, iters=10),
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=_device_ms(torch, library), call_ms=_call_ms(torch, kernel),
        plain_call_ms=_call_ms(torch, plain, iters=20), library_call_ms=_call_ms(torch, library),
    )
    print(f"[kernel] embedding_bag {row['shape']}: bit-exact (mean and sum), "
          f"kernel_ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
          f"library_ms={row['library_ms']:.6f} bound_ms={row['bound_ms']:.6f} "
          f"(rows read {rows}) call_ms={row['call_ms']:.6f} plain_call_ms={row['plain_call_ms']:.6f} "
          f"library_call_ms={row['library_call_ms']:.6f}", flush=True)
    return row


def main() -> int:
    torch, card = _setup()
    import numpy as np

    from repro_torch.kernels import build

    t_all = t = time.perf_counter()
    build.build(verbose=True)
    build.library()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    operands, waves = _capture_operands(torch)
    results = _kernel_checks(torch, operands, waves)
    _adversarial_checks(torch)
    _bag_adversarial_checks(torch)
    print(f"[phase] data-path kernel checks and adversarial inputs "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    # the serving path: counts set to 0 just before, read just after
    t = time.perf_counter()
    build.LAUNCHES.reset()
    batches, session, serve_s, _ = _serve(torch, "torch")
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"[serve] main path launches {launches}", flush=True)
    for name in ("xor_decrypt", "dense_unpack", "ragged_gather", "fused_transform"):
        if launches.get(name, 0) <= 0:
            raise RuntimeError(f"the main path never launched {name}")
    n_rows = sum(p.num_rows for p in session.table.partitions.values())
    if sum(len(b["label"]) for b in batches) != n_rows or len(batches) != n_rows // BATCH:
        raise RuntimeError(f"served {len(batches)} batches, expected {n_rows // BATCH}")
    from repro_torch.configs.dlrm_paper import CONFIG

    ids_shape = (BATCH, CONFIG.num_tables, CONFIG.max_ids_per_feature)
    for b in batches:
        if (b["dense"].shape != (BATCH, CONFIG.num_dense)
                or not np.isfinite(b["dense"]).all()):
            raise RuntimeError(f"bad dense block {b['dense'].shape}")
        if b["sparse_ids"].shape != ids_shape or b["sparse_mask"].shape != ids_shape:
            raise RuntimeError(f"bad sparse block {b['sparse_ids'].shape}")

    ref_batches, _, ref_serve_s, _ = _serve(torch, "numpy")
    if sorted(map(_digest, batches)) != sorted(map(_digest, ref_batches)):
        raise RuntimeError("torch-engine batches differ from the numpy-engine batches")
    print("[serve] batches byte-identical to the numpy engines", flush=True)
    # the same pair in the other order (numpy first), then a profiled
    # torch run for the device's busy and idle share
    serve = {"torch": [serve_s], "numpy": [ref_serve_s]}
    for engine in ("numpy", "torch"):
        serve[engine].append(_serve(torch, engine)[2])
    _, _, prof_serve_s, device_s = _serve(torch, "torch", profile=True)
    print(json.dumps({"serve": {
        "batches": len(batches), "rows": n_rows, "serve_s": serve,
        "profiled_torch_serve_s": prof_serve_s, "device_busy_s": device_s,
        "device_idle_share": 1 - device_s / prof_serve_s,
    }}), flush=True)

    for r in results:
        r["launches"] = launches[r["name"]]
    print(f"[phase] serving path {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    train_launches, bag_operands = _train_path(torch)
    print(f"[phase] trainer path {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    bag = _bag_checks(torch, bag_operands)
    bag["launches"] = train_launches["embedding_bag"]
    results.append(bag)
    print(f"[phase] embedding_bag checks {time.perf_counter() - t:.1f} s", flush=True)
    print(f"[phase] total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
