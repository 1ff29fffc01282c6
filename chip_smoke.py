#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` (timed).
3. Captures every kernel's operands from one stripe of the full-width
   ``dlrm-paper`` data path, holds each kernel bit-exact (``torch.equal``)
   against its plain PyTorch version on the card, and times kernel, plain
   version and, where one exists, the single PyTorch call computing the
   same function (device time from torch.profiler, call time from CUDA
   events).  Then holds each kernel bit-exact on adversarial inputs the
   main path never makes (NaN payloads, signed zeros, subnormals, extreme
   parameters, both tile layouts, long bitmaps, every byte shift).
4. Serves every batch of the full-width ``dlrm-paper`` DPP session through
   ``dlrm_dpp_batches(device="cuda")`` with the launch counts set to 0 just
   before, checks that every kernel launched, that the batches have the
   expected shapes and finite dense values, and that they are
   byte-identical (as a multiset: workers race) to the port's numpy-engine
   session on the same data; prints batches/s and rows/s.
5. Prints one JSON line with every kernel's numbers, the card's line, and
   last the result line ``{"ok": true, "device": {...}}``.

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


def _setup():
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch not found beside this script")
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
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

    table, spec = dlrm_dpp_table(BATCH)
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

    from repro_torch.launch.train import dlrm_dpp_batches

    t0 = time.perf_counter()
    batches, session = dlrm_dpp_batches(
        BATCH, device="cuda", engine=engine, decode_engine=engine,
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


def main() -> int:
    torch, card = _setup()
    import numpy as np

    from repro_torch.kernels import build

    t = time.perf_counter()
    build.build(verbose=True)
    build.library()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)

    operands, waves = _capture_operands(torch)
    results = _kernel_checks(torch, operands, waves)
    _adversarial_checks(torch)

    # the main path: counts set to 0 just before, read just after
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
    from repro_torch.launch import train

    ids_shape = (BATCH, train.DLRM_PAPER_NUM_TABLES, train.DLRM_PAPER_MAX_IDS_PER_FEATURE)
    for b in batches:
        if (b["dense"].shape != (BATCH, train.DLRM_PAPER_NUM_DENSE)
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
    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
