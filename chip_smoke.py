#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` (timed) and
   prints ``-Xptxas -v``'s registers and spills of both routes of
   ``fused_transform``, ``embedding_bag``, ``dense_unpack`` and
   ``ragged_gather``, and of ``sigrid_hash``.
3. Captures the data path's kernel operands from one stripe of the
   full-width ``dlrm-paper`` data path, holds each kernel bit-exact
   (``torch.equal``) against its plain PyTorch version on the card, and
   times kernel, plain version and, where one exists, the single PyTorch
   call computing the same function (device time and call time both from
   CUDA events: ``_queued_ms``, ``_call_ms``); ``fused_transform``,
   ``dense_unpack`` and ``ragged_gather`` by both routes, the route the
   engine's operands take and the general route.  Then holds each kernel
   (both routes where the new route takes the operands) bit-exact on
   adversarial inputs the main path never makes (NaN payloads, signed
   zeros, subnormals, extreme parameters, both tile layouts, rows 4k to
   4k+3, unsorted, tied, signed-zero, +inf and NaN border rows, aligned
   and unaligned views, bitmaps of 1 to 33 and 1,250 words with C of 1
   to above 32 W, all-absent and all-present features, every byte shift,
   non-consecutive, straddling and mixed-shift index pairs, the last word
   pair; for ``embedding_bag`` empty bags, duplicate ids, the
   last row, fractional weights, L of 0 to 300 and E of 1 to 1000,
   NaN/inf rows under a mask of
   0, subnormal rows, a table of more than 2^31 elements);
   ``xor_decrypt`` and ``torch.bitwise_xor`` again in turns, and the two
   routes of ``dense_unpack``, of ``ragged_gather`` and of
   ``fused_transform`` (at each wave) in turns.  Then the
   standalone ``sigrid_hash`` and ``bucketize`` (no path launches them)
   bit-exact at one batch's tiles and on adversarial inputs, and timed
   (``sigrid_hash`` also in turns beside ``torch.bitwise_xor``, which
   moves the same bytes, and at an 8-batch tile; ``bucketize`` also with
   tied, 5,000 sorted and 5,000 unsorted borders).
4. The serving path: serves every batch of the full-width ``dlrm-paper``
   DPP session through ``dlrm_dpp_batches(CONFIG, 512, device="cuda")``
   with the launch counts set to 0 just before, checks that every data
   path kernel launched (``fused_transform`` by its vec route only,
   ``dense_unpack`` and ``ragged_gather`` once a stripe by their warp and
   vec routes only), that
   the batches have the expected shapes and
   finite dense values, and that they are byte-identical (as a multiset:
   workers race) to the port's numpy-engine session on the same data;
   prints batches/s and rows/s.
5. The trainer path: with the launch counts set to 0, serves the
   ``dlrm-paper`` session with its one cut (vocab 200,000 per table instead
   of 2,000,000: the store's host tier is numpy on the host) and trains 8
   steps of the tiered-store DLRM on its batches with ``Trainer(...,
   device="cuda")`` and ``kernel_bags=True``; checks that
   ``embedding_bag`` launched, by its warp route only, that every loss is
   finite, and that a CPU
   trainer (same batches, same tables) stepped in turn with a card
   trainer, loading the card's MLP weights and AdamW state before each
   step and taking the card's ReLU pattern (its pre-activations within
   1e-4 of their rms of the card's), gives every step's loss within rtol
   1e-4, and that after each
   step the card's AdamW mu, nu and grad norm are within 1e-4 (relative
   norm, leaf by leaf) of the CPU's and its parameters within 1e-5 of the
   float64 AdamW update of its own state; the lockstep card losses must
   equal the main run's.  Prints per-step times, steps/s, rows/s, the hot
   rate and the device idle share of a profiled run, then holds both
   routes of ``embedding_bag`` bit-exact against its plain version at the
   operands of that run's first fully-hot lookup and times them (and
   ``torch.nn.functional.embedding_bag`` as the library yardstick), in
   turns too; then the same at every bag of one step (21,504 bags of the
   first batch folded onto the same hot-slot table), not gated on time.
6. The LM serving path (``_lm_serve_path``): with the launch counts set to 0,
   serves the full-width ``qwen3-8b`` (36 layers, d_model 4096, bf16,
   weights drawn on the card from seed 0) through
   ``repro_torch.launch.serve.serve``: batch 4, prompt 1024, 32 decode
   steps, cache 128.  Checks that the tensor-core ``flash_attention_sm90``
   launched once per layer of the prefill (36), the FMA route not once,
   and that the logits are finite; prints
   ``prefill_s``, ``decode_tok_per_s``, peak device memory and the device
   idle share of a profiled decode loop.  Then a full-width
   ``BatchingServer`` (4 slots, 4 requests of 16 prompt tokens and 8 new
   ones) and its ``latency_report``.
7. ``flash_attention`` against its plain version on the card: at q/k/v
   captured from layers 0 and 35 of that prefill (bf16 through both
   routes, the tensor-core one the path takes and the FMA one, and the
   same operands in float32 at the float32 tolerance), and on
   adversarial inputs through whichever route each takes (S of 1, 63, 65,
   127, 129, 1000; T != S; D of 32, 48, 64, 128; GQA groups 1, 4 and 8;
   float32 and bf16; the model's transposed views; scores of |s| ~ 1e4
   whose running max moves at every key tile); times both routes, the
   plain version and ``F.scaled_dot_product_attention`` beside the bound,
   the tensor-core route and SDPA again in turns.  Then a depth-2,
   full-width model from one set of weights on the card and on the CPU:
   logits within tolerance and greedy tokens equal, in float32 and bf16.
8. The SSM serving path (``_ssm_serve_path``): with the launch counts set
   to 0, serves the full-width ``mamba2-2.7b`` (64 layers, d_model 2560,
   80 heads, d_state 128, bf16, seed 0) through the same ``serve`` (batch
   4, prompt 1024 = 4 chunks, 32 decode steps); checks that the
   tensor-core ``ssd_chunk_forward_sm90`` launched once per layer (64),
   the FMA route not once, and nothing else, and that the logits are
   finite; prints ``prefill_s``,
   ``decode_tok_per_s``, peak memory, the bounds, and a profiled 4-step
   decode window; then a 4-slot ``BatchingServer``.  ``ssd_chunk_forward``
   against its plain version (the sequential float32 recurrence) at the
   scan operands of layers 0 and 63 (bf16 through both routes, float32
   through the FMA route, y and the final state) and on adversarial
   inputs through the route each takes (S from 1 to 1000 with ragged
   chunks, 1-8 groups, P and N of 16-128, chunks of 64-256, |cs| to 1e4,
   A = 0, an initial state; bf16 cases that must take the tensor-core
   route), both routes timed beside the bound and in turns.  Then a
   depth-2, full-width model from one set of weights on the card and on
   the CPU (prompt 512).
9. Prints one JSON line with every kernel's numbers (fifteen: the nine
   TPU kernels' ports, ``fused_transform``, ``dense_unpack``,
   ``ragged_gather``, ``embedding_bag``, flash attention and the SSD scan
   by both of their routes), the card's line,
   and last the result line
   ``{"ok": true, "device": {...}}``.

The device's busy time and idle share in steps 4-6 and 8 come from
torch.profiler; where it records no device activity they print as not
measured (null in the JSON), and nothing else depends on it.

Float32 matrix products run in full float32 (TF32 is switched off for
both matmul and cuDNN).

Any failure raises, so the script exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor-core peak
BATCH = 512
# the trainer path's one cut: the store's host tier is numpy on the host,
# 43 GB at 2M rows per table; the card's work is the same at either vocab
TRAIN_VOCAB = 200_000
TRAIN_STEPS = 8
HOT_ROWS = 1024
# the trainer's lockstep check, per leaf: the card's mu, nu and grad norm
# against the CPU's after one step from the same state, and the card's
# parameters against the float64 AdamW update of its own state (float32
# rounding of the update is ~3e-7 of it; an update 1% off moves weights by
# more than 1e-5 of their norm)
LOCKSTEP_RTOL = 1e-4
UPDATE_RTOL = 1e-5
# the LM serving path: launch/serve.py's flags at full qwen3-8b width
LM_BATCH, LM_PROMPT, LM_DECODE, LM_CACHE = 4, 1024, 32, 128
LM_CAPTURE_LAYERS = (0, 35)
# flash_attention against its plain version: the reference's own sweep
# (tests/test_kernels.py) holds its Pallas kernel to its dense oracle
# within atol = rtol = 2e-5 (float32) and 2e-2 (bf16) on unit-normal
# operands.  Attention is linear in v, so on operands whose v has another
# scale the same bound applies to out / rms(v).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the SSM serving path: mamba2-2.7b at full width, the same serve flags
SSM_CAPTURE_LAYERS = (0, 63)
# ssd_chunk_forward against its plain version (the sequential float32
# recurrence), per element within atol * rms(want) + rtol * |want|: float32
# the reference's own SSD sweep (tests/test_kernels.py: atol 5e-4, rtol
# 1e-3 against its sequential oracle), applied in units of rms(want); bf16
# 2e-2 of both, as the flash_attention sweep's bf16 bound (the kernel
# rounds m to bf16 before m.x, 2^-9 relative a term, and y to bf16).  The
# final state is float32 in both types and held to the float32 bound.
SSD_TOL = {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}
# kernels whose registers and spills the build prints on their own lines
PTXAS_KERNELS = ("fused_transform_kernel", "fused_transform_vec_kernel",
                 "embedding_bag_kernel", "embedding_bag_warp_kernel",
                 "dense_unpack_kernel", "dense_unpack_warp_kernel",
                 "ragged_gather_kernel", "ragged_gather_vec_kernel",
                 "sigrid_hash_kernel")


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


def _ptxas_summary(text: str, names) -> list:
    """One line a kernel instantiation of ``nvcc -Xptxas -v``'s output whose
    mangled name holds one of ``names``: its registers and spills."""
    out, fn, props = [], None, []
    for line in text.splitlines() + ["ptxas info    : Compiling entry function '' for"]:
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m:
            if fn and any(n in fn for n in names):
                out.append(f"{fn}: " + "; ".join(props))
            fn, props = m.group(1), []
        elif fn and ("spill" in line or "registers" in line):
            props.append(line.split(":", 1)[-1].strip())
    return out


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


def _queued_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call, from CUDA events around ``iters`` calls that
    the host queues while the stream is held by a sleep kernel, so the
    calls run back to back on the device whatever their host cost.  The
    sleep starts at about twice the host's queueing time; where it ends
    before the host has queued every call (the sleep was short, or the
    launch queue filled), it doubles and fewer calls are queued."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    cycles = max(10 ** 8, int(4e9 * host_s))    # ~2 GHz: 10**8 cycles ~50 ms
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()          # the sleep outlasted the queueing
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 2
        iters = max(1, iters // 2)
    raise RuntimeError("the host could not queue the calls ahead of the device")


def _device_by_name(torch, prof):
    """Device time (us) of a profiler run by kernel or copy name, and the
    number of device kernels and copies it recorded.  ``({}, 0)`` where the
    profiler recorded no device activity: CUPTI tracing is not open to
    every process on every machine, so the busy times and idle shares read
    from it are then reported as not measured (null), and no check or
    kernel time rests on it."""
    cuda = torch.autograd.DeviceType.CUDA
    by_name, count = {}, 0
    for ev in prof.key_averages():
        if ev.device_type == cuda and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total
            count += ev.count
    return by_name, count


def _warm_profiler(torch) -> None:
    """One throwaway torch.profiler session on a small op.  The first
    session of a process can record no device activity, and it stalls the
    host while CUPTI starts (a profiled DPP session then ran 7x slower and
    re-served splits whose leases ran out), so it is taken before any
    measured one."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(10):
            x = x * 1.0
        torch.cuda.synchronize()


def _idle_share(busy_s, wall_s):
    return None if busy_s is None else 1 - busy_s / wall_s


def _fmt(x, spec: str) -> str:
    return "not measured" if x is None else format(x, spec)


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
    # dense_unpack and ragged_gather by both routes each: the route the
    # engine's operands take and the general route on the same operands
    bm, vals = operands["dense_unpack"]
    src, idx, sh = operands["ragged_gather"]
    if kdecode.dense_unpack_route(bm) != "warp":
        raise RuntimeError(f"the main path's bitmap {tuple(bm.shape)} does not take the warp route")
    if kdecode.ragged_gather_route(idx, sh) != "vec":
        raise RuntimeError(f"the main path's idx {tuple(idx.shape)} does not take the vec route")
    out_elems = bm.shape[0] * bm.shape[1] * 32
    for name, kernel_route, fn in (("dense_unpack_warp", "warp", kdecode.dense_unpack_warp),
                                   ("dense_unpack", "block", kdecode.dense_unpack_block)):
        cases.append(dict(
            name=name, kernel_route=kernel_route, source="src/repro_torch/csrc/decode.cu",
            replaces="src/repro/kernels/decode.py:87",
            kernel=lambda fn=fn: fn(bm, vals),
            plain=lambda: ref.dense_unpack(bm, vals), library=None,
            bytes=nbytes(bm, vals) + 4 * out_elems, ops=6 * out_elems,
            shape=f"bitmap {tuple(bm.shape)} values {tuple(vals.shape)}",
        ))
    for name, kernel_route, fn in (("ragged_gather_vec", "vec", kdecode.ragged_gather_vec),
                                   ("ragged_gather", "scalar", kdecode.ragged_gather_scalar)):
        cases.append(dict(
            name=name, kernel_route=kernel_route, source="src/repro_torch/csrc/decode.cu",
            replaces="src/repro/kernels/decode.py:125",
            kernel=lambda fn=fn: fn(src, idx, sh),
            plain=lambda: ref.ragged_gather(src, idx, sh), library=None,
            bytes=nbytes(src, idx, sh) + nbytes(idx), ops=4 * idx.numel(),
            shape=f"src {tuple(src.shape)} idx {tuple(idx.shape)}",
        ))
    # fused_transform by both routes at each wave: the 16-byte-lane route
    # the engine's tiles take, and the general route on the same operands
    ft_routes = (("fused_transform_vec", "vec", kft.fused_transform_vec),
                 ("fused_transform", "scalar", kft.fused_transform_scalar))
    for w, (mat, codes, p0, p1, brd) in enumerate(waves):
        if kft.route(mat, features_major=True) != "vec":
            raise RuntimeError(f"wave {w}'s tile {tuple(mat.shape)} does not take the vec route")
        present = sorted(set(codes.tolist()))
        for name, kernel_route, fn in ft_routes:
            cases.append(dict(
                name=name, kernel_route=kernel_route, wave=w,
                source="src/repro_torch/csrc/fused_transform.cu",
                replaces="src/repro/kernels/fused_transform.py:81",
                kernel=(lambda fn=fn, mat=mat, codes=codes, p0=p0, p1=p1, brd=brd:
                        fn(mat, codes, p0, p1, brd, features_major=True)),
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
        ms = _queued_ms(torch, c["kernel"])
        plain_ms = _queued_ms(torch, c["plain"], iters=5)
        library_ms = _queued_ms(torch, c["library"]) if c["library"] else None
        call_ms = _call_ms(torch, c["kernel"])
        plain_call_ms = _call_ms(torch, c["plain"], iters=20)
        library_call_ms = _call_ms(torch, c["library"]) if c["library"] else None
        bytes_ms = c["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = c["ops"] / FP32_OPS_PER_S * 1e3
        rows.append(dict(
            name=c["name"], wave=c.get("wave"), shape=c["shape"],
            route="cuda", **({"kernel_route": c["kernel_route"]} if "kernel_route" in c else {}),
            source=c["source"], replaces=c["replaces"],
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
    # xor_decrypt and torch.bitwise_xor in turns: is the kernel's gap to the
    # library call outside the spread of either?
    xor = cases[0]
    turns = {"kernel": [], "library": []}
    for _ in range(3):
        turns["kernel"].append(_queued_ms(torch, xor["kernel"]))
        turns["library"].append(_queued_ms(torch, xor["library"]))
        turns["library"].append(_queued_ms(torch, xor["library"]))
        turns["kernel"].append(_queued_ms(torch, xor["kernel"]))
    rows[0]["turns_ms"] = turns
    print(f"[kernel] xor_decrypt and torch.bitwise_xor in turns: {json.dumps(turns)}",
          flush=True)
    # dense_unpack's and ragged_gather's two routes in turns (new, general,
    # general, new), three times
    for new_name, general_name in (("dense_unpack_warp", "dense_unpack"),
                                   ("ragged_gather_vec", "ragged_gather")):
        new_c, general_c = (next(c for c in cases if c["name"] == n)
                            for n in (new_name, general_name))
        turns = {new_name: [], general_name: []}
        for _ in range(3):
            turns[new_name].append(_queued_ms(torch, new_c["kernel"]))
            turns[general_name].append(_queued_ms(torch, general_c["kernel"]))
            turns[general_name].append(_queued_ms(torch, general_c["kernel"]))
            turns[new_name].append(_queued_ms(torch, new_c["kernel"]))
        next(r for r in rows if r["name"] == new_name)["turns_ms"] = turns
        print(f"[kernel] {new_name} and {general_name} {new_c['shape']} in turns "
              f"{json.dumps(turns)}", flush=True)
    # fused_transform's two routes at each wave in turns (vec, scalar,
    # scalar, vec), three times
    for w in range(len(waves)):
        vec, scalar = (next(c for c in cases if c["name"] == n and c.get("wave") == w)
                       for n, _, _ in ft_routes)
        turns = {"fused_transform_vec": [], "fused_transform": []}
        for _ in range(3):
            turns["fused_transform_vec"].append(_queued_ms(torch, vec["kernel"]))
            turns["fused_transform"].append(_queued_ms(torch, scalar["kernel"]))
            turns["fused_transform"].append(_queued_ms(torch, scalar["kernel"]))
            turns["fused_transform_vec"].append(_queued_ms(torch, vec["kernel"]))
        next(r for r in rows if r["name"] == "fused_transform_vec"
             and r["wave"] == w)["turns_ms"] = turns
        print(f"[kernel] fused_transform wave {w} {vec['shape']}: vec and scalar routes in "
              f"turns {json.dumps(turns)}", flush=True)
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
        else:
            q.pop("turns_ms", None)       # each wave keeps its own
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
    def ft_check(label, mat, c, a, b, bd):
        """The features-major tile through the route it takes and, where that
        is the vec route, through the general route too; then rows-major
        (the general route), with and without borders."""
        rm = mat.T.contiguous()
        want_fm = ref.fused_transform(rm, c, a, b, bd).T
        fm = [kft.fused_transform(mat, c, a, b, bd, features_major=True)]
        vec = kft.route(mat, features_major=True) == "vec"
        if vec:
            fm += [kft.fused_transform_vec(mat, c, a, b, bd, features_major=True),
                   kft.fused_transform_scalar(mat, c, a, b, bd, features_major=True)]
        for got, want in [(g, want_fm) for g in fm] + [
            (kft.fused_transform(rm, c, a, b, bd), ref.fused_transform(rm, c, a, b, bd)),
            (kft.fused_transform(rm, c, a, b), ref.fused_transform(rm, c, a, b)),
        ]:
            if not torch.equal(got, want):
                raise RuntimeError(f"fused_transform: adversarial {label} {tuple(mat.shape)} "
                                   "differs")
        return "vec and scalar routes" if vec else "scalar route"

    # rows 4k (the vec route) and 4k+1..4k+3 (the general route)
    for rows in (37, 38, 39, 40, 70_000, 70_001):
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
        taken = ft_check("every op", mat, c, a, b, bd)
        print(f"[adversarial] fused_transform {tuple(mat.shape)} every op, both layouts, "
              f"features-major by the {taken}: bit-exact", flush=True)

    # BUCKETIZE_F border rows the engine never fuses, one per feature of a
    # features-major tile: unsorted, ties, signed zeros, +inf inside and
    # as padding, NaN, one NaN border, 300 sorted and 300 unsorted borders
    # (several of a warp's check steps), subnormals; values NaN, +-inf,
    # +-0, subnormal, on the borders and random
    nb = 300
    inf, nan = np.inf, np.nan
    specials = [
        [2.0, -1.0, 0.5, -3.0], [-1.0, -1.0, -1.0, 0.0, 0.0, 1.0, 1.0],
        [-0.0, 0.0, -0.0, 0.0], [0.0, -0.0], [-1.0, inf, inf, inf], [inf],
        [-inf, -inf, 0.0, inf], [-1.0, nan, 0.5], [nan], [0.0, 1.0, nan],
        [1e-40, -1e-42, 3e-39], [-1e-40, 0.0, 1e-40], list(np.linspace(-3, 3, 63)),
    ]
    rng = np.random.default_rng(17)
    brd_rows = [np.pad(np.array(r, np.float32), (0, nb - len(r)), constant_values=inf)
                for r in specials]
    brd_rows.append(np.sort(rng.standard_normal(nb).astype(np.float32)).round(1))
    brd_rows.append(rng.standard_normal(nb).astype(np.float32))
    bd = cuda(np.stack(brd_rows), torch.float32)
    feats = len(brd_rows)
    ties = np.array([-3.0, -1.0, -0.0, 0.0, 0.5, 1.0, 2.0, 1e-40, -1e-40, inf, -inf, nan,
                     3e-39, -1e-42], np.float32)
    c = cuda(np.full(feats, ref.OP_BUCKETIZE_F, np.int32))
    z = cuda(np.zeros(feats, np.int32))
    for rows in (4096, 4098):
        vals = (rng.standard_normal((feats, rows)) * 3).astype(np.float32)
        vals[:, : len(ties)] = ties
        vals[:, len(ties): 2 * len(ties)] = ties[::-1]
        taken = ft_check("BUCKETIZE_F borders", cuda(vals.view(np.int32)), c, z, z, bd)
        print(f"[adversarial] fused_transform BUCKETIZE_F ({feats}, {rows}) on unsorted, "
              f"tied, +-0.0, +inf and NaN border rows, by the {taken}: bit-exact", flush=True)

    # views of one buffer: a base 16 bytes in (the vec route) and 4 bytes
    # in (the general route)
    flat = cuda(lanes(rng, 8 * 512 + 8, False))
    for off in (4, 1):
        mat = flat[off: off + 8 * 512].view(8, 512)
        c8 = cuda(np.array([0, 1, 2, 3, 4, 5, 6, 9], np.int32))
        a8 = cuda(np.array([0, 7, 0, -50, -100, bits(-1.0), 0, 0], np.int32))
        b8 = cuda(np.array([0, 33, 13, 50, 10, bits(1.0), 0, 0], np.int32))
        bd8 = cuda(np.stack([np.sort(rng.standard_normal(17) * 50)] * 8).astype(np.float32),
                   torch.float32)
        want = "vec" if off == 4 else "scalar"
        if kft.route(mat, features_major=True) != want:
            raise RuntimeError(f"fused_transform: a view {off * 4} bytes in takes "
                               f"{kft.route(mat, features_major=True)}, expected {want}")
        ft_check(f"view {off * 4} bytes in", mat, c8, a8, b8, bd8)
    print("[adversarial] fused_transform views 16 bytes in (vec route) and 4 bytes in "
          "(scalar route): bit-exact", flush=True)

    rng = np.random.default_rng(1)
    for n in (1, 40_000):
        w = cuda(rng.integers(*i32, (n, 128), dtype=np.int64).astype(np.int32))
        if not torch.equal(kdecode.xor_decrypt(w), ref.xor_decrypt(w)):
            raise RuntimeError(f"xor_decrypt: ({n}, 128) differs")
    print("[adversarial] xor_decrypt (1, 128) and (40000, 128): bit-exact", flush=True)

    def unpack_check(bm, v):
        """Through the route it takes and both routes by name (the warp
        route where it takes the bitmap); returns the route."""
        want = ref.dense_unpack(bm, v)
        fns = [kdecode.dense_unpack, kdecode.dense_unpack_block]
        taken = kdecode.dense_unpack_route(bm)
        if taken == "warp":
            fns.append(kdecode.dense_unpack_warp)
        for fn in fns:
            if not torch.equal(fn(bm, v), want):
                raise RuntimeError(f"{fn.__name__}: bitmap {tuple(bm.shape)} values "
                                   f"{tuple(v.shape)} differs")
        return taken

    special = np.array([0x7FC00001, 0x7F800001, 0xFFC00000, 0x7F800000, 0x80000000, 0, 1,
                        0x807FFFFF], np.uint32).view(np.int32)    # NaN payloads, subnormals
    for rows, feats in [(1, 3), (40_000, 7)] + [(32 * w - (w % 3), 7) for w in range(1, 34)]:
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
            values[f, : min(n, len(special))] = special[: min(n, len(special))]
        bm, vals = cuda(bitmap), cuda(values)
        wide = cuda(np.concatenate(                               # C above 32 W
            [values, rng.integers(*i32, (feats, 37), dtype=np.int64).astype(np.int32)], 1))
        # C of 1, C below the rows present (ranks clip to C-1), C of 32 W, C above
        for v in (vals, vals[:, :1].contiguous(), vals[:, :3].contiguous(), wide):
            want_route = "warp" if nw <= 32 else "block"
            if unpack_check(bm, v) != want_route:
                raise RuntimeError(f"dense_unpack: {nw} words took the wrong route")
    print("[adversarial] dense_unpack 1 to 33 and 1250 words x 7 features (all absent, all "
          "present), C of 1, 3, 32 W and above, NaN payloads and subnormals: warp route "
          "(up to 32 words) and block route bit-exact", flush=True)

    def gather_check(src, idx, sh, label):
        want = ref.ragged_gather(src, idx, sh)
        fns = [kdecode.ragged_gather, kdecode.ragged_gather_scalar]
        taken = kdecode.ragged_gather_route(idx, sh)
        if taken == "vec":
            fns.append(kdecode.ragged_gather_vec)
        for fn in fns:
            if not torch.equal(fn(src, idx, sh), want):
                raise RuntimeError(f"{fn.__name__}: {label} ({tuple(idx.shape)}) differs")
        return taken

    for m in (1, 20_000):
        n = max(m, 2) * 128
        src = cuda(rng.integers(*i32, (n // 128, 128), dtype=np.int64).astype(np.int32))
        idx = rng.integers(0, n - 1, (m, 128)).astype(np.int32)
        sh = rng.choice(np.array([0, 8, 16, 24], np.int32), (m, 128))
        idx.flat[0], sh.flat[0] = n - 2, 24                 # the last word pair
        if gather_check(src, cuda(idx), cuda(sh), "random") != "vec":
            raise RuntimeError("ragged_gather: fresh (M, 128) operands took the scalar route")
        # runs of consecutive words at one shift a run, runs of random even
        # lengths, pairs of non-consecutive indices, a pair that straddles
        # two runs, a pair of mixed shifts, a run to the last word pair
        flat_i, flat_s = idx.reshape(-1), sh.reshape(-1)
        at = 0
        while at < flat_i.size:
            length = min(2 * int(rng.integers(1, 60)), flat_i.size - at)
            flat_i[at: at + length] = int(rng.integers(0, n - length - 1)) + np.arange(length)
            flat_s[at: at + length] = rng.choice([0, 8, 16, 24])
            at += length
        flat_i[0:4] = [5, 9, 6, 7]
        flat_i[4:8], flat_s[4:8] = [20, 21, 22, 23], [8, 8, 16, 8]
        flat_i[8:12], flat_s[8:12] = np.arange(n - 5, n - 1), 24
        flat_i[13:15] = [flat_i[13], flat_i[13] + 40]
        flat_i[-1], flat_s[-1] = n - 2, 24
        if gather_check(src, cuda(idx), cuda(sh), "runs") != "vec":
            raise RuntimeError("ragged_gather: fresh (M, 128) operands took the scalar route")
        for shift in (0, 8, 16, 24):                        # every shift, all runs
            run = cuda((np.arange(m * 128) % (n - 1)).astype(np.int32).reshape(m, 128))
            gather_check(src, run, torch.full_like(run, shift), f"runs at shift {shift}")
    # views 4 bytes into one buffer take the scalar route
    buf_i = cuda(rng.integers(0, 255, 8 * 128 + 1).astype(np.int32))
    buf_s = cuda(rng.choice(np.array([0, 8, 16, 24], np.int32), 8 * 128 + 1))
    src = cuda(rng.integers(*i32, (2, 128), dtype=np.int64).astype(np.int32))
    if gather_check(src, buf_i[1:].view(8, 128), buf_s[1:].view(8, 128), "view") != "scalar":
        raise RuntimeError("ragged_gather: a view 4 bytes in took the vec route")
    print("[adversarial] ragged_gather every shift, random indices, runs of even lengths, "
          "non-consecutive, straddling and mixed-shift pairs, the last word pair, M of 1 and "
          "20000: vec and scalar routes bit-exact; a view 4 bytes in: scalar route bit-exact",
          flush=True)


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
        by_name, _ = _device_by_name(torch, prof)
        device_s = sum(by_name.values()) / 1e6 if by_name else None
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
          + (f", device busy {_fmt(device_s, '.6f')} s, idle share "
             f"{_fmt(_idle_share(device_s, serve_s), '.4f')}" if profile else "")
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
        """Both modes through the route the operands take and, where that
        is the warp route, through the block route too."""
        out = {}
        fns = [kbag.embedding_bag]
        if kbag.route(table) == "warp":
            fns += [kbag.embedding_bag_warp, kbag.embedding_bag_block]
        for mode in ("mean", "sum"):
            want = ref.embedding_bag(table, ids, mask, mode=mode)
            for fn in fns:
                got = fn(table, ids, mask, mode=mode)
                torch.cuda.synchronize()
                if not _bits_equal(torch, got, want):
                    raise RuntimeError(f"{fn.__name__} ({mode}): {name} differs from the "
                                       "plain version")
            out[mode] = got
        return out

    rng = np.random.default_rng(12)
    taken = {"warp": [], "block": []}
    # E 1, 16, 40, 1000 and 42 (not a multiple of 4, over 512) and 4, 124,
    # 128, 132, 512 (one to four 128-column stripes, partial stripes); L of
    # 0, 1, 31, 32, 33 and 300 (runs of 32 slots and their ragged ends)
    for v, e, b, l in ((7, 1, 5, 3), (50, 16, 9, 8), (300, 40, 64, 33),
                       (1000, 128, 100, 300), (64, 1000, 8, 5), (10, 128, 4, 0),
                       (100, 4, 40, 1), (200, 124, 33, 31), (300, 128, 50, 33),
                       (150, 132, 20, 32), (64, 512, 16, 300), (500, 128, 17, 1),
                       (80, 42, 9, 7), (90, 516, 6, 33)):
        table = rng.standard_normal((v, e)).astype(np.float32)
        ids = rng.integers(0, v, (b, l)).astype(np.int32)
        mask = (rng.random((b, l)) < 0.6).astype(np.float32)
        if l:
            mask[: b // 3] *= rng.random((b // 3, l)).astype(np.float32) * 3   # fractional
            mask[-1] = 0.0                                                   # an empty bag
            ids[-2] = ids[-2, 0]                                             # duplicates
            ids[0, 0] = v - 1                                                # the last row
            ids[1, 0], ids[2, -1] = -3, v + 5                                # clamped
        table, ids, mask = cuda(table), cuda(ids), cuda(mask)
        taken[kbag.route(table)].append(e)
        out = check(f"(V={v}, E={e}, B={b}, L={l})", table, ids, mask)
        empty = out["sum"][-1:] if l else out["sum"]
        if not torch.equal(empty, torch.zeros_like(empty)):
            raise RuntimeError("embedding_bag: an empty bag is not 0")
    print(f"[adversarial] embedding_bag E by the warp and block routes {taken}, L of 0, "
          "1, 3, 5, 7, 8, 31, 32, 33 and 300, empty/duplicate/last-row/clamped/fractional: "
          "bit-exact", flush=True)

    # views of one buffer: a table 16 bytes in (the warp route) and 4 bytes
    # in (the block route)
    flat = cuda(rng.standard_normal(64 * 128 + 4).astype(np.float32))
    ids = cuda(rng.integers(0, 64, (30, 33)).astype(np.int32))
    mask = cuda((rng.random((30, 33)) < 0.7).astype(np.float32))
    for off, want in ((4, "warp"), (1, "block")):
        table = flat[off: off + 64 * 128].view(64, 128)
        if kbag.route(table) != want:
            raise RuntimeError(f"embedding_bag: a table {off * 4} bytes in takes "
                               f"{kbag.route(table)}, expected {want}")
        check(f"table {off * 4} bytes in", table, ids, mask)
    print("[adversarial] embedding_bag tables 16 bytes in (warp route) and 4 bytes in "
          "(block route): bit-exact", flush=True)

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


def _make_trainer(cfg, tables, device, store_cls=None):
    """The tiered-store DLRM trainer of the trainer path, and its store."""
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
    return trainer, store


def _rel_diff(a, b) -> float:
    """Norm of a - b over the norm of b, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _host_state(state):
    """A CPU copy of a trainer's dense state (params, AdamW mu/nu/step)."""
    opt = state["opt"]
    return {"params": {k: v.cpu().clone() for k, v in state["params"].items()},
            "opt": {"mu": {k: v.cpu().clone() for k, v in opt["mu"].items()},
                    "nu": {k: v.cpu().clone() for k, v in opt["nu"].items()},
                    "step": opt["step"].cpu().clone()},
            "step": state["step"]}


def _lockstep(torch, cfg, batches, tables):
    """Each step on the card and on the CPU from the same dense state: a
    card trainer and a CPU trainer step through the batches in turn, and
    before each step the CPU trainer loads the card trainer's MLP weights
    and AdamW state; each store runs free (its row-wise AdaGrad scales
    every row by that row's own rms, so rounding stays rounding).
    Free-running, AdamW's normalized first updates turn rounding-level
    gradient differences into loss differences of up to 5e-3 in 8 steps on
    some batch orders, on correct code.  After each step the card's dense
    state is held leaf by leaf: its mu and nu (which carry the clipped
    gradients) against the CPU's, within a relative norm of
    ``LOCKSTEP_RTOL``, its grad norm likewise, and its parameters against
    the AdamW update worked out here in float64 from its pre-step
    parameters and its post-step mu and nu, within ``UPDATE_RTOL``.
    The CPU step takes the card's ReLU pattern: a ReLU derivative jumps at
    0, and the one or two of a step's ~1.9 M pre-activations that lie
    within float32 rounding of 0 (about one step in three at this
    config's init) can round to opposite sides on the two devices, which
    moves a leaf's gradient by up to 1.5e-3 of its norm (as float32 against
    float64 does on the CPU; with the other's pattern both agree within
    3e-7).  The card's pre-activations are recorded, the CPU's ReLUs keep
    exactly the units the card kept, and the CPU's pre-activations must
    agree with the card's within ``LOCKSTEP_RTOL`` of their rms, so the
    borrowed pattern can differ only where a value is at rounding level.
    Returns both loss lists, the worst relative differences and the CPU's
    seconds."""
    from repro_torch.optim.optimizers import wsd_schedule

    card, _ = _make_trainer(cfg, tables, "cuda")
    cpu, _ = _make_trainer(cfg, tables, "cpu")
    oc = card.opt_cfg
    state = card.init_state()
    cpu_s = 0.0
    worst = {"mu": 0.0, "nu": 0.0, "grad_norm": 0.0, "params_vs_update": 0.0,
             "params_vs_cpu": 0.0, "pre_activations": 0.0, "relu_flips": 0}
    relu = torch.relu
    card_z, cpu_z = [], []

    def card_relu(z):
        card_z.append(z.detach().float().cpu())
        return relu(z)

    def cpu_relu(z):
        zc = card_z[len(cpu_z)]
        cpu_z.append(z.detach())
        return torch.where(zc > 0, z, torch.zeros((), dtype=z.dtype))

    for i, batch in enumerate(batches):
        for trainer in (card, cpu):
            trainer.cfg.max_steps = i + 1
        pre = _host_state(state)
        card_z.clear()
        cpu_z.clear()
        torch.relu = card_relu
        try:
            state = card.fit([batch], state)
        finally:
            torch.relu = relu
        torch.relu = cpu_relu
        t0 = time.perf_counter()
        try:
            cpu_after = cpu.fit([batch], pre)
        finally:
            torch.relu = relu
        cpu_s += time.perf_counter() - t0
        after = _host_state(state)
        n = i + 1
        if not card_z or len(cpu_z) != len(card_z):
            raise RuntimeError(f"step {n}: {len(card_z)} ReLUs on the card, "
                               f"{len(cpu_z)} on the CPU")
        flips = sum(int(((zc > 0) != (z > 0)).sum()) for zc, z in zip(card_z, cpu_z))
        forward = max(float((z - zc).abs().max() / zc.square().mean().sqrt().clamp_min(1e-30))
                      for zc, z in zip(card_z, cpu_z))
        if forward > LOCKSTEP_RTOL:
            raise RuntimeError(f"step {n}: the card's pre-activations differ from the "
                               f"CPU's by {forward:.3e} of their rms")
        diffs = {"mu": 0.0, "nu": 0.0, "params_vs_update": 0.0, "params_vs_cpu": 0.0,
                 "pre_activations": forward, "relu_flips": flips}
        lr = float(wsd_schedule(oc, torch.tensor(n, dtype=torch.int32)))
        # the betas as the update holds them, in float32
        bc1, bc2 = (1.0 - float(torch.tensor(b, dtype=torch.float32)) ** n
                    for b in (oc.beta1, oc.beta2))
        for k, p in pre["params"].items():
            for m in ("mu", "nu"):
                diffs[m] = max(diffs[m], _rel_diff(after["opt"][m][k], cpu_after["opt"][m][k]))
            mu, nu, p64 = (after["opt"]["mu"][k].double(), after["opt"]["nu"][k].double(),
                           p.double())
            delta = (mu / bc1) / ((nu / bc2).sqrt() + oc.eps)
            if p.dim() >= 2:
                delta = delta + oc.weight_decay * p64
            diffs["params_vs_update"] = max(diffs["params_vs_update"],
                                            _rel_diff(after["params"][k], p64 - lr * delta))
            diffs["params_vs_cpu"] = max(diffs["params_vs_cpu"],
                                         _rel_diff(after["params"][k], cpu_after["params"][k]))
        g_card, g_cpu = card.history[-1].grad_norm, cpu.history[-1].grad_norm
        diffs["grad_norm"] = abs(g_card - g_cpu) / abs(g_cpu)
        if int(after["opt"]["step"]) != n or int(cpu_after["opt"]["step"]) != n:
            raise RuntimeError(f"step {n}: AdamW step {int(after['opt']['step'])} on the "
                               f"card, {int(cpu_after['opt']['step'])} on the CPU")
        if max(diffs["mu"], diffs["nu"], diffs["grad_norm"]) > LOCKSTEP_RTOL:
            raise RuntimeError(f"step {n}: the card's dense gradients differ from the "
                               f"CPU's: {diffs}")
        if diffs["params_vs_update"] > UPDATE_RTOL:
            raise RuntimeError(f"step {n}: the card's parameters are not the AdamW update "
                               f"of its state: {diffs}")
        worst = {k: v + diffs[k] if k == "relu_flips" else max(v, diffs[k])
                 for k, v in worst.items()}
    return ([m.loss for m in card.history], [m.loss for m in cpu.history], worst, cpu_s)


def _train_run(torch, cfg, batches, tables, device, store_cls=None, profile=False):
    """Train ``TRAIN_STEPS`` steps of the tiered-store DLRM on the recorded
    batches; returns the trainer, its store, the wall seconds and (when
    profiled) the profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    trainer, store = _make_trainer(cfg, tables, device, store_cls)
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
    train on its batches on the card, compare each step with the CPU from
    the card's dense state, profile a third run;
    returns the main run's launch counts, the kernel operands of the
    profiled run's first fully-hot lookup, and every bag of the first step
    folded onto the same hot-slot table."""
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
    if launches.get("embedding_bag_warp", 0) <= 0 or store.stats.kernel_bags <= 0:
        raise RuntimeError("the trainer path never launched embedding_bag's warp route")
    if launches.get("embedding_bag", 0) != 0:
        raise RuntimeError(f"the trainer path launched embedding_bag's block route "
                           f"{launches['embedding_bag']} times: every lookup must take "
                           "the warp route")
    gpu_hist = trainer.history
    gpu_losses = np.array([m.loss for m in gpu_hist])
    if not np.isfinite(gpu_losses).all():
        raise RuntimeError(f"non-finite losses {gpu_losses}")
    stats = {k: getattr(store.stats, k) for k in (
        "lookups", "hot_hits", "dram_fetches", "kernel_bags", "admitted", "evicted",
        "refreshed", "hot_rows")}
    del trainer, store

    step_losses, cpu_losses, state_diffs, cpu_s = _lockstep(torch, cfg, batches, tables)
    step_losses, cpu_losses = np.array(step_losses), np.array(cpu_losses)
    rel = np.abs(cpu_losses - step_losses) / np.abs(cpu_losses)
    if not np.allclose(step_losses, cpu_losses, rtol=1e-4, atol=0):
        raise RuntimeError(f"card losses {step_losses} vs CPU losses {cpu_losses}")
    if not np.array_equal(step_losses, gpu_losses):
        raise RuntimeError(f"the card's lockstep losses {step_losses} differ from its main "
                           f"run's {gpu_losses}")
    print(f"[train] card vs CPU, every step from the card's dense state: max rel loss "
          f"diff {rel.max():.3e} (rtol 1e-4); worst per-leaf relative norm of the card's "
          f"post-step state minus the CPU's: mu {state_diffs['mu']:.3e}, nu "
          f"{state_diffs['nu']:.3e}, grad norm {state_diffs['grad_norm']:.3e} (limit "
          f"{LOCKSTEP_RTOL:g}), params {state_diffs['params_vs_cpu']:.3e} (not held: AdamW "
          f"amplifies rounding); card params vs the float64 AdamW update of its own state "
          f"{state_diffs['params_vs_update']:.3e} (limit {UPDATE_RTOL:g}); pre-activations "
          f"{state_diffs['pre_activations']:.3e} of their rms (limit {LOCKSTEP_RTOL:g}), "
          f"{state_diffs['relu_flips']} ReLUs the CPU took from the card; CPU losses "
          f"{cpu_losses.tolist()}; the card's losses equal its main run's", flush=True)

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
    by_name, _ = _device_by_name(torch, prof)
    busy_s = copy_s = bag_s = None
    if by_name:
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
        "max_rel_loss_diff": float(rel.max()), "lockstep_state_rel_diff": state_diffs,
        "card_step_metrics": [dataclasses.asdict(m) for m in gpu_hist],
        "store_stats": stats, "hot_rate": gpu_hist[-1].hot_rate,
        "profiled_host_s": dict(store.seconds, embed_fetch=sum(
            m.embed_fetch_s for m in trainer.history), step_time=step_s,
            mlp_step=step_s - store.seconds["apply_sparse_update"]),
        "device_busy_s": busy_s, "device_copy_s": copy_s,
        "device_embedding_bag_s": bag_s, "device_idle_share": _idle_share(busy_s, prof_s),
        "device_top_us": dict(top),
    }}), flush=True)
    operands = store.operands
    del trainer, store
    # every bag of the first step as the hot tier would serve it once it
    # covers the step: each table's ids folded onto its HOT_ROWS slots of
    # the same flattened (T * HOT_ROWS, E) table
    sid, smask = batches[0]["sparse_ids"], batches[0]["sparse_mask"]
    t = sid.shape[1]
    slot = sid % HOT_ROWS + (np.arange(t) * HOT_ROWS)[None, :, None]
    step_bags = (slot.reshape(-1, sid.shape[2]).astype(np.int32),
                 np.ascontiguousarray(smask.reshape(-1, sid.shape[2]), np.float32))
    return launches, operands, step_bags


def _bag_checks(torch, operands, step_bags, launches):
    """``embedding_bag`` at the operands of the trainer's first fully-hot
    lookup: both routes bit-exact against the plain version in both modes,
    times of each route, the plain version and
    ``torch.nn.functional.embedding_bag`` beside the bound, and the two
    routes again in turns (warp, block, block, warp, three times): one row
    for each route.  Then every bag of one step (``step_bags``) through
    both routes: bit-exact and timed beside its bound and
    ``F.embedding_bag``, not gated on time."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import ref

    routes = (("embedding_bag_warp", "warp", kbag.embedding_bag_warp),
              ("embedding_bag", "block", kbag.embedding_bag_block))

    def measure(table, ids, mask, label):
        if kbag.route(table) != "warp":
            raise RuntimeError(f"embedding_bag: {label} does not take the warp route")
        for mode in ("mean", "sum"):
            want = ref.embedding_bag(table, ids, mask, mode=mode)
            for name, _, fn in routes:
                got = fn(table, ids, mask, mode=mode)
                torch.cuda.synchronize()
                if not _bits_equal(torch, got, want):
                    raise RuntimeError(f"{name} ({mode}): kernel disagrees with its plain "
                                       f"version at {label}")
        err = float((got - want).abs().max().item())
        ids64 = ids.long()
        denom = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
        plain = lambda: ref.embedding_bag(table, ids, mask, mode="mean")
        library = lambda: F.embedding_bag(ids64, table, mode="sum",
                                          per_sample_weights=mask) / denom
        if not torch.allclose(library(), plain(), rtol=1e-5, atol=1e-6):
            raise RuntimeError(f"F.embedding_bag disagrees with the plain version at {label}")
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
        common = dict(
            shape=f"table {tuple(table.shape)} ids/mask {tuple(ids.shape)} {label}, rows "
                  f"read {rows}",
            max_abs_err=err, plain_ms=_queued_ms(torch, plain, iters=5),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=_queued_ms(torch, library),
            plain_call_ms=_call_ms(torch, plain, iters=20),
            library_call_ms=_call_ms(torch, library),
        )
        out = []
        for name, kernel_route, fn in routes:
            kernel = lambda fn=fn: fn(table, ids, mask, mode="mean")
            row = dict(name=name, route="cuda", kernel_route=kernel_route,
                       source="src/repro_torch/csrc/embedding_bag.cu",
                       replaces="src/repro/kernels/embedding_bag.py:40",
                       launches=launches.get(name, 0), **common,
                       ms=_queued_ms(torch, kernel), call_ms=_call_ms(torch, kernel))
            out.append(row)
            print(f"[kernel] {name} {row['shape']}: bit-exact (mean and sum), "
                  f"kernel_ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
                  f"library_ms={row['library_ms']:.6f} bound_ms={row['bound_ms']:.6f} "
                  f"call_ms={row['call_ms']:.6f} plain_call_ms={row['plain_call_ms']:.6f} "
                  f"library_call_ms={row['library_call_ms']:.6f}", flush=True)
        turns = {name: [] for name, _, _ in routes}
        order = [routes[0], routes[1], routes[1], routes[0]]
        for _ in range(3):
            for name, _, fn in order:
                turns[name].append(
                    _queued_ms(torch, lambda fn=fn: fn(table, ids, mask, mode="mean")))
        out[0]["turns_ms"] = turns
        print(f"[kernel] embedding_bag {label}: warp and block routes in turns "
              f"{json.dumps(turns)}", flush=True)
        return out

    table, ids, mask = (torch.from_numpy(a).cuda() for a in operands)
    rows = measure(table, ids, mask, f"the first fully-hot lookup, {ids.shape[0]} bags")
    step_ids, step_mask = (torch.from_numpy(a).cuda() for a in step_bags)
    step = measure(table, step_ids, step_mask,
                   f"every bag of one step, {step_ids.shape[0]} bags")
    for row, one_step in zip(rows, step):
        row["one_step"] = {k: one_step[k] for k in (
            "shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call_ms", "turns_ms") if k in one_step}
    return rows


def _flash_close(got, want, v, dtype_name):
    """The largest |got - want| in units of rms(v), and the largest share of
    its per-element bound that an element uses: the sweep's bound is
    tol * (1 + |want|) in those units, so within tolerance means a share
    of at most 1."""
    tol = FLASH_TOL[dtype_name]
    scale = float(v.float().square().mean().sqrt())
    diff = (got.float() - want.float()).abs() / scale
    share = diff / (tol * (1 + want.float().abs() / scale))
    return float(diff.max()), float(share.max())


def _lm_serve_path(torch):
    """Full-width qwen3-8b through the port's serve path on the card, with
    the launch counts set to 0 just before and read just after; then a
    profiled decode loop, the attention operands of layers 0 and 35 from
    another prefill, and the full-width BatchingServer.  Returns the
    launches, the captured operands and the path's numbers."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import BatchingServer, Request, ServerConfig

    t = time.perf_counter()
    model = build_model(CONFIG, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[lm] {CONFIG.name}: {n_params} parameters ({param_bytes / 1e9:.3f} GB) drawn "
          f"on the card in {time.perf_counter() - t:.2f} s", flush=True)
    # a first call at the same shapes (cuBLAS handles, the kernel's set-up)
    t = time.perf_counter()
    serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=2,
                cache_len=LM_CACHE)
    print(f"[lm] first call (prefill + 2 decode steps) {time.perf_counter() - t:.2f} s",
          flush=True)

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.reset()
    out = serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=LM_DECODE,
                      cache_len=LM_CACHE)
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    print(f"[lm] main path launches {launches}", flush=True)
    # the prefill's bf16, D=128 operands take the tensor-core route in every
    # layer, and the FMA route not once
    if (launches.get("flash_attention_sm90", 0) != CONFIG.num_layers
            or launches.get("flash_attention", 0) != 0):
        raise RuntimeError(f"the prefill launched flash_attention_sm90 "
                           f"{launches.get('flash_attention_sm90', 0)} times and "
                           f"flash_attention {launches.get('flash_attention', 0)} times, "
                           f"expected {CONFIG.num_layers} and 0")
    if not torch.isfinite(out["logits"].float()).all():
        raise RuntimeError("non-finite logits")
    tokens = out["tokens"]
    if (tuple(tokens.shape) != (LM_BATCH, 1 + LM_DECODE) or int(tokens.min()) < 0
            or int(tokens.max()) >= CONFIG.vocab_size):
        raise RuntimeError(f"bad sampled tokens {tuple(tokens.shape)}")
    print(f"[lm] serve: prefill_s={out['prefill_s']:.6f} decode_s={out['decode_s']:.6f} "
          f"decode_tok_per_s={out['decode_tok_per_s']:.3f} peak device memory "
          f"{peak / 1e9:.3f} GB, finite logits, sampled tokens[0] "
          f"{tokens[0, :16].tolist()}", flush=True)

    # the decode loop again under the profiler: the device's busy share
    cache = model.init_cache(LM_BATCH, LM_CACHE)
    token = tokens[:, :1].to("cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(LM_DECODE):
            logits, cache = model.decode_step({"token": token, "pos": i, "cache": cache})
            token = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        decode_wall = time.perf_counter() - t0
    by_name, device_ops = _device_by_name(torch, prof)
    busy = sum(by_name.values()) / 1e6 if by_name else None
    launches_per_step = device_ops / LM_DECODE if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[lm] profiled decode loop: {decode_wall:.6f} s wall, device busy "
          f"{_fmt(busy, '.6f')} s, idle share {_fmt(_idle_share(busy, decode_wall), '.5f')}, "
          f"{_fmt(launches_per_step, '.0f')} device kernels "
          f"and copies a step (profile and summary "
          f"{time.perf_counter() - t:.2f} s)", flush=True)
    del cache, logits

    # what one decode step must read: every weight but the token table, of
    # which only B rows are read (the cache's few rows are left out)
    tok_bytes = model.embed.tok.numel() * model.embed.tok.element_size()
    step_bytes = param_bytes - tok_bytes + LM_BATCH * CONFIG.d_model * 2
    decode_bound = LM_BATCH / (step_bytes / HBM_BYTES_PER_S)

    # the attention operands of layers 0 and 35, from another prefill: the
    # (B, H, S, D) views that blocked_attention hands to kernels.ops
    captured = []
    original = ops.flash_attention

    def capture(q, k, v, **kw):
        if len(captured) in LM_CAPTURE_LAYERS:
            captured.append((q.clone(), k.clone(), v.clone()))
        else:
            captured.append(None)
        return original(q, k, v, **kw)

    ops.flash_attention = capture
    t = time.perf_counter()
    try:
        serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=0,
                    cache_len=LM_CACHE)
    finally:
        ops.flash_attention = original
    operands = {i: captured[i] for i in LM_CAPTURE_LAYERS}
    print(f"[lm] operands of layers {LM_CAPTURE_LAYERS} captured in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    numbers = {
        "config": CONFIG.name, "parameters": n_params, "param_bytes": param_bytes,
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "decode_steps": LM_DECODE,
        "cache_len": LM_CACHE, "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
        "decode_tok_per_s": out["decode_tok_per_s"],
        "flash_attention_sm90_launches": launches.get("flash_attention_sm90", 0),
        "flash_attention_launches": launches.get("flash_attention", 0),
        "peak_device_bytes": peak, "profiled_decode_s": decode_wall,
        "decode_device_busy_s": busy, "decode_device_idle_share": _idle_share(busy, decode_wall),
        "decode_step_bytes": step_bytes, "decode_bound_tok_per_s": decode_bound,
        "decode_device_top_us": {k[:80]: v for k, v in top},
        "decode_device_ops_per_step": launches_per_step,
        "sampled_tokens_0": tokens[0, :16].tolist(),
    }
    del captured, model, out
    torch.cuda.empty_cache()

    # the full-width BatchingServer: 4 slots, 4 requests
    t = time.perf_counter()
    server = BatchingServer(CONFIG, ServerConfig(slots=4, cache_len=LM_CACHE), seed=0,
                            device="cuda")
    print(f"[lm] BatchingServer built in {time.perf_counter() - t:.2f} s", flush=True)
    rng = np.random.default_rng(1)
    for rid in range(4):
        server.submit(Request(rid=rid, prompt=rng.integers(0, CONFIG.vocab_size, 16)
                              .astype(np.int32), max_new_tokens=8))
    t0 = time.perf_counter()
    done = server.run()
    server_s = time.perf_counter() - t0
    if len(done) != 4 or any(len(r.output) != 8 for r in done) or any(
            not 0 <= tok < CONFIG.vocab_size for r in done for tok in r.output):
        raise RuntimeError(f"BatchingServer finished {[len(r.output) for r in done]}")
    report = BatchingServer.latency_report(done)
    print(f"[lm] BatchingServer: 4 requests in {server_s:.3f} s, latency_report "
          f"{json.dumps(report)}", flush=True)
    numbers["server"] = {"slots": 4, "requests": 4, "prompt_len": 16, "new_tokens": 8,
                         "run_s": server_s, "latency_report": report,
                         "outputs": {r.rid: r.output for r in done}}
    del server
    torch.cuda.empty_cache()
    return launches, operands, numbers


def _flash_checks(torch, operands, launches):
    """``flash_attention`` at the main path's operands (layers 0 and 35):
    in bf16 as the path runs it, through the tensor-core route the
    operands pick and through the FMA route, each within the sweep's bf16
    tolerance of the bf16 and the float32 plain versions; and on the same
    operands cast to float32 (same shapes and strides, the FMA route),
    within the sweep's float32 tolerance of the float32 plain version,
    which holds the masking, tiling and GQA indexing at main-path sizes to
    2e-5.  Then times of both routes, the plain version and
    ``F.scaled_dot_product_attention`` beside the bound (layer 0's
    operands): one row for each route."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    worst = {"flash_attention_sm90": 0.0, "flash_attention": 0.0}
    for layer, (q, k, v) in sorted(operands.items()):
        if kflash.route(q, k, v) != "sm90":
            raise RuntimeError(f"layer {layer}'s operands do not take the tensor-core route")
        want = ref.flash_attention(q, k, v)
        q32, k32, v32 = q.float(), k.float(), v.float()
        want32 = ref.flash_attention(q32, k32, v32)
        got32 = kflash.flash_attention(q32, k32, v32, causal=True)
        torch.cuda.synchronize()
        err32, share32 = _flash_close(got32, want32, v32, "float32")
        del got32
        if share32 > 1:
            raise RuntimeError(f"flash_attention: layer {layer}'s operands: float32 "
                               f"{err32:.3e} of rms(v), share of the bound {share32:.3f}")
        for name, fn in (("flash_attention_sm90", kflash.flash_attention),
                         ("flash_attention", kflash.flash_attention_fma)):
            got = fn(q, k, v, causal=True)
            torch.cuda.synchronize()
            err, share = _flash_close(got, want, v, "bfloat16")
            err_f, share_f = _flash_close(got, want32, v, "bfloat16")
            if max(share, share_f) > 1:
                raise RuntimeError(f"{name}: layer {layer}'s operands: bf16 {err:.3e} (plain "
                                   f"bf16), {err_f:.3e} (plain f32) of rms(v); shares of the "
                                   f"bound {share:.3f}, {share_f:.3f}")
            worst[name] = max(worst[name], err)
            print(f"[kernel] {name} layer {layer} q {tuple(q.shape)} k {tuple(k.shape)} "
                  f"strides {q.stride()}: bf16 max |kernel - plain| {err:.3e} rms(v) (bf16 "
                  f"plain), {err_f:.3e} (f32 plain), largest share of the per-element bound "
                  f"{FLASH_TOL['bfloat16']:g}*(1 + |want|/rms(v)) {share:.3f} and "
                  f"{share_f:.3f}", flush=True)
        print(f"[kernel] flash_attention layer {layer} float32 (FMA route) vs float32 plain "
              f"{err32:.3e} rms(v), share of {FLASH_TOL['float32']:g}*(1 + |want|/rms(v)) "
              f"{share32:.3f}; rms(v) {float(v.float().square().mean().sqrt()):.4f}",
              flush=True)
        del want, want32, q32, k32, v32

    q, k, v = operands[LM_CAPTURE_LAYERS[0]]
    b, h, s, d = q.shape
    t = k.shape[2]
    plain = lambda: ref.flash_attention(q, k, v)
    library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    lib_err, lib_share = _flash_close(library(), plain(), v, "bfloat16")
    if lib_share > 1:
        raise RuntimeError(f"SDPA disagrees with the plain version: {lib_err:.3e} rms(v)")
    # bytes: q, k, v read once and out written once; operations: 2 products
    # of 2*D flops for each (query, key) pair the causal mask keeps
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v)) + q.numel() * q.element_size()
    pairs = b * h * sum(min(i + 1, t) for i in range(s))
    flops = 4 * d * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    shape = (f"q {tuple(q.shape)} k/v {tuple(k.shape)} {str(q.dtype).split('.')[-1]} causal "
             f"(layer {LM_CAPTURE_LAYERS[0]} of the qwen3-8b prefill)")
    plain_ms = _queued_ms(torch, plain, iters=5)
    plain_call_ms = _call_ms(torch, plain, iters=5)
    library_ms = _queued_ms(torch, library)
    library_call_ms = _call_ms(torch, library, iters=20)
    rows = []
    # device times from CUDA events around calls queued behind a sleep:
    # after the profiled decode loop, torch.profiler's sums for these calls
    # came out below the float32 FMA floor of the kernel's work, or empty
    for name, source, fn in (
            ("flash_attention_sm90", "src/repro_torch/csrc/flash_attention_sm90.cu",
             kflash.flash_attention_sm90),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             kflash.flash_attention_fma)):
        kernel = lambda fn=fn: fn(q, k, v, causal=True)
        row = dict(
            name=name, route="cuda", source=source,
            replaces="src/repro/kernels/flash_attention.py:62", shape=shape,
            launches=launches.get(name, 0), max_abs_err=worst[name],
            ms=_queued_ms(torch, kernel), plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms, call_ms=_call_ms(torch, kernel, iters=20),
            plain_call_ms=plain_call_ms, library_call_ms=library_call_ms,
        )
        rows.append(row)
        print(f"[kernel] {name} {shape}: kernel_ms={row['ms']:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
              f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}: {flops} flops, {nbytes} "
              f"bytes) call_ms={row['call_ms']:.6f} plain_call_ms={plain_call_ms:.6f} "
              f"library_call_ms={library_call_ms:.6f}", flush=True)
    # the two routes and SDPA again, in turns, for the spread within this run
    turns = {"flash_attention_sm90": [], "library": []}
    for _ in range(3):
        turns["flash_attention_sm90"].append(
            _queued_ms(torch, lambda: kflash.flash_attention_sm90(q, k, v, causal=True)))
        turns["library"].append(_queued_ms(torch, library))
    rows[0]["turns_ms"] = turns
    print(f"[kernel] flash_attention_sm90 and SDPA in turns: {json.dumps(turns)}", flush=True)
    return rows


def _flash_adversarial_checks(torch) -> None:
    """``flash_attention`` against its plain version on inputs the main
    path never makes, through whichever route each takes: S of 1, 63, 65
    and 1000, T != S (full attention), head dims 32, 48 (padded to 64), 64
    and 128, GQA groups 1 and 4, both types; and scores of |s| ~ 1e4 from
    integer q and k at D=64 (every score exact in float32), one case with a
    key ramp that moves each row's running max at every key tile.  Then the
    tensor-core route at its edges: S and T of 1, 127, 129 and 1000, T != S
    with full attention, D 64 and 128, GQA groups 1, 4 and 8, and the
    model's transposed (B, S, H, D) views.  bf16 results are held to the
    float32 plain version on the same operands as well."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(13)
    routes = {"sm90": 0, "fma": 0}

    def check(name, q, k, v, causal):
        dtype = str(q.dtype).split(".")[-1]
        routes[kflash.route(q, k, v)] += 1
        got = kflash.flash_attention(q, k, v, causal=causal)
        want32 = ref.flash_attention(q.float(), k.float(), v.float(), causal=causal)
        wants = [("f32 plain", want32)]
        if name != "large":       # the bf16 plain version rounds |s| ~ 1e4 scores to bf16
            wants.append(("plain", ref.flash_attention(q, k, v, causal=causal)))
        torch.cuda.synchronize()
        for label, want in wants:
            err, share = _flash_close(got, want, v, dtype)
            if share > 1:
                raise RuntimeError(f"flash_attention {name} {tuple(q.shape)} k "
                                   f"{tuple(k.shape)} {dtype} causal={causal} route "
                                   f"{kflash.route(q, k, v)}: {err:.3e} rms(v) from the "
                                   f"{label} version")

    def normal(b, h, kvh, s, t, d, dtype, model_layout=False):
        if model_layout:
            shapes = ((b, s, h, d), (b, t, kvh, d), (b, t, kvh, d))
            return [torch.randn(x, generator=gen, device="cuda").to(dtype).transpose(1, 2)
                    for x in shapes]
        return [torch.randn(x, generator=gen, device="cuda").to(dtype)
                for x in ((b, h, s, d), (b, kvh, t, d), (b, kvh, t, d))]

    shapes = ((1, 2, 2, 1, 1, 32, True), (2, 4, 1, 63, 63, 64, True),
              (2, 8, 2, 65, 65, 128, True), (1, 4, 4, 1000, 1000, 128, True),
              (2, 8, 2, 65, 100, 128, False), (2, 4, 4, 1, 300, 64, False),
              (3, 4, 1, 130, 77, 48, False), (1, 4, 1, 200, 130, 32, True))
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, kvh, s, t, d, causal in shapes:
            check("normal", *normal(b, h, kvh, s, t, d, dtype), causal)
        # large scores: integers in [-128, 128] are exact in bf16, every dot
        # (< 2^24) exact in float32, and the scale 1/8 exact at D=64
        q = torch.randint(-128, 129, (2, 4, 200, 64), generator=gen, device="cuda")
        k = torch.randint(-128, 129, (2, 2, 200, 64), generator=gen, device="cuda")
        v = torch.randn((2, 2, 200, 64), generator=gen, device="cuda")
        s_max = float((q.float() @ k.float().repeat_interleave(2, 1).transpose(-1, -2)).abs()
                      .max()) / 8
        check("large", q.to(dtype), k.to(dtype), v.to(dtype), True)
        check("large", q.to(dtype), k.to(dtype), v.to(dtype), False)
        # a ramp: row i's largest score is at key i, so the running max moves
        # at every key tile; scores up to 16 * 64 * 125 / 8 = 16000
        ramp = (torch.arange(1000, device="cuda") // 8).clamp(max=125)
        q = torch.full((1, 2, 1000, 64), 16.0, device="cuda")
        k = ramp[None, None, :, None].expand(1, 2, 1000, 64).float()
        v = torch.randn((1, 2, 1000, 64), generator=gen, device="cuda")
        check("large", q.to(dtype), k.to(dtype), v.to(dtype), True)
    fma_cases = routes["fma"]
    # the tensor-core route at its edges: ragged S and T against its 128-row
    # tiles, T != S, D 64 and 128, GQA groups 1, 4 and 8, the model layout
    edges = [(1, 8, 8, s, s, 128, True) for s in (1, 127, 129, 1000)]
    edges += [(2, 8, 2, 127, 129, 64, False), (1, 8, 1, 129, 1000, 128, False),
              (2, 8, 8, 1000, 1, 64, False), (1, 8, 2, 1, 1000, 128, False),
              (2, 4, 1, 129, 300, 128, True), (1, 8, 1, 1000, 127, 64, True)]
    for b, h, kvh, s, t, d, causal in edges:
        for layout in (False, True):
            ops = normal(b, h, kvh, s, t, d, torch.bfloat16, model_layout=layout)
            if kflash.route(*ops) != "sm90":
                raise RuntimeError(f"edge case {(b, h, kvh, s, t, d)} took the FMA route")
            check("edge", *ops, causal)
    # the |s| ~ 1e4 integer scores and the ramp at D = 128 on the tensor cores
    q = torch.randint(-128, 129, (1, 8, 300, 128), generator=gen, device="cuda")
    k = torch.randint(-128, 129, (1, 1, 300, 128), generator=gen, device="cuda")
    v = torch.randn((1, 1, 300, 128), generator=gen, device="cuda")
    check("large", q.bfloat16(), k.bfloat16(), v.bfloat16(), True)
    q = torch.full((1, 4, 1000, 128), 16.0, device="cuda")
    k = ramp[None, None, :, None].expand(1, 1, 1000, 128).float()
    v = torch.randn((1, 1, 1000, 128), generator=gen, device="cuda")
    check("large", q.bfloat16(), k.bfloat16(), v.bfloat16(), True)
    print(f"[adversarial] flash_attention S in (1, 63, 65, 127, 129, 130, 200, 300, 1000), "
          f"T != S, D in (32, 48, 64, 128), groups 1/2/4/8, f32 and bf16, the model's "
          f"transposed views, |s| up to {s_max:.0f} and a ramp to 16000: within tolerance "
          f"({routes['sm90']} cases on the tensor-core route, {fma_cases} on the FMA route)",
          flush=True)


def _lm_card_vs_cpu(torch):
    """A depth-2, full-width qwen3-8b from one set of weights (drawn on the
    card from seed 1) on the card and on the CPU: prefill of 2 prompts of
    64 tokens, then 4 greedy decode steps.  Every greedy token equal in
    both types; float32 logits within rtol = atol = 1e-3, bf16 logits
    each within 10% of their rms (the CPU tests' bound against the
    reference)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.models import build_model

    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, CONFIG.vocab_size, (2, 64)).astype(np.int32))
    result = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = dataclasses.replace(CONFIG, num_layers=2, param_dtype=dtype, compute_dtype=dtype)
        card = build_model(cfg, device="cuda").init(1)
        cpu = build_model(cfg, device="cpu")
        cpu.load_state_dict(card.state_dict())
        runs = {}
        for dev, model in (("cuda", card), ("cpu", cpu)):
            t0 = time.perf_counter()
            logits, _ = model.prefill({"tokens": prompt})
            steps = [logits.float().cpu()]
            cache = model.init_cache(2, 16)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            toks = [token.cpu()]
            for pos in range(4):
                logits, cache = model.decode_step({"token": token, "pos": pos, "cache": cache})
                steps.append(logits.float().cpu())
                token = torch.argmax(logits, dim=-1).to(torch.int32)
                toks.append(token.cpu())
            runs[dev] = (steps, torch.cat(toks, dim=1), time.perf_counter() - t0)
            del cache, logits
        del card, cpu
        torch.cuda.empty_cache()
        (g_steps, g_toks, g_s), (c_steps, c_toks, c_s) = runs["cuda"], runs["cpu"]
        errs = [float((g - c).abs().max()) for g, c in zip(g_steps, c_steps)]
        rel = [e / float(c.square().mean().sqrt()) for e, c in zip(errs, c_steps)]
        same = bool(torch.equal(g_toks, c_toks))
        if name == "float32":
            if not all(torch.allclose(g, c, rtol=1e-3, atol=1e-3)
                       for g, c in zip(g_steps, c_steps)):
                raise RuntimeError(f"card vs CPU float32 logits differ by up to {max(errs)}")
        elif max(rel) > 0.1:
            raise RuntimeError(f"card vs CPU bf16 logits differ by {max(rel):.3f} of their rms")
        if not same:
            raise RuntimeError(f"card vs CPU {name} greedy tokens differ: {g_toks.tolist()} "
                               f"vs {c_toks.tolist()}")
        result[name] = {"max_abs_logit_diff": errs, "max_diff_over_rms": rel,
                        "greedy_tokens_equal": same, "card_tokens": g_toks.tolist(),
                        "cpu_tokens": c_toks.tolist(), "card_s": g_s, "cpu_s": c_s}
        print(f"[lm] card vs CPU, depth 2 full width, {name}: max |logit diff| per call "
              f"{['%.3e' % e for e in errs]} ({['%.3e' % r for r in rel]} of rms), greedy "
              f"tokens equal: {same}; card {g_s:.2f} s, CPU {c_s:.2f} s", flush=True)
    return result


def _standalone_checks(torch, operands):
    """``sigrid_hash`` and ``bucketize`` at one ``dlrm-paper`` batch's shapes:
    the (512, 1344) sparse id tile (42 tables x 32 ids, ids drawn over the
    whole int32 range from a seed, max_value 2,000,000) and the (512, 504)
    dense tile that ``dense_unpack`` gives for the first stripe (NaN where
    a value is absent) with the reference's 63 bucketize borders.  Each
    bit-exact against its plain version; times of kernel, plain version
    and, for ``bucketize``, ``torch.bucketize`` (which agrees where v is
    not NaN: a search puts NaN past the last border, the count gives 0).
    ``sigrid_hash`` is timed again in turns beside ``torch.bitwise_xor(ids,
    salt)``, which moves the same bytes with one op (``same_bytes_ms``: a
    floor, not a library time for the function), at this tile and at an
    8-batch one.  No path of the port launches either kernel (launches
    0)."""
    import numpy as np

    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.kernels import bucketize as kbucketize
    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import ref
    from repro_torch.kernels import sigrid_hash as ksigrid

    rng = np.random.default_rng(21)
    ids = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, (
        BATCH, CONFIG.num_tables * CONFIG.max_ids_per_feature), dtype=np.int64)
        .astype(np.int32)).cuda()
    salt, max_value = 1, CONFIG.vocab_per_table
    bm, vals = operands["dense_unpack"]
    dense = kdecode.dense_unpack(bm, vals).view(torch.float32).T.contiguous()
    borders = torch.linspace(-3, 3, 63, dtype=torch.float64).float().cuda()
    cases = [
        dict(name="sigrid_hash", source="src/repro_torch/csrc/sigrid_hash.cu",
             replaces="src/repro/kernels/sigrid_hash.py:34",
             kernel=lambda: ksigrid.sigrid_hash(ids, salt, max_value),
             plain=lambda: ref.sigrid_hash(ids, salt, max_value), library=None,
             bytes=8 * ids.numel(), ops=12 * ids.numel(),
             shape=f"ids {tuple(ids.shape)} max_value {max_value}"),
        dict(name="bucketize", source="src/repro_torch/csrc/bucketize.cu",
             replaces="src/repro/kernels/bucketize.py:30",
             kernel=lambda: kbucketize.bucketize(dense, borders),
             plain=lambda: ref.bucketize(dense, borders),
             library=lambda: torch.bucketize(dense, borders, out_int32=True),
             bytes=8 * dense.numel() + 4 * borders.numel(),
             ops=dense.numel() * borders.numel(),
             shape=f"values {tuple(dense.shape)} borders {borders.numel()} "
                   f"(NaN {int(torch.isnan(dense).sum())})"),
    ]
    rows = []
    for c in cases:
        got, want = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            raise RuntimeError(f"{c['name']}: kernel disagrees with its plain version")
        if c["library"] is not None:
            ok = ~torch.isnan(dense)
            if not torch.equal(c["library"]()[ok], want[ok]):
                raise RuntimeError(f"{c['name']}: library call disagrees with the plain version")
        ms = _queued_ms(torch, c["kernel"])
        plain_ms = _queued_ms(torch, c["plain"], iters=5)
        library_ms = _queued_ms(torch, c["library"]) if c["library"] else None
        bytes_ms = c["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = c["ops"] / FP32_OPS_PER_S * 1e3
        row = dict(
            name=c["name"], shape=c["shape"], route="cuda", source=c["source"],
            replaces=c["replaces"], launches=0, max_abs_err=0, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms, call_ms=_call_ms(torch, c["kernel"]),
            plain_call_ms=_call_ms(torch, c["plain"], iters=20),
            library_call_ms=_call_ms(torch, c["library"]) if c["library"] else None,
        )
        if c["name"] == "bucketize":
            row["more_borders"] = _bucketize_more_borders(torch, dense)
        rows.append(row)
        print(f"[kernel] {c['name']} {c['shape']}: bit-exact, kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms} "
              f"bound_ms={row['bound_ms']:.6f} call_ms={row['call_ms']:.6f} "
              f"plain_call_ms={row['plain_call_ms']:.6f} "
              f"library_call_ms={row['library_call_ms']}", flush=True)
    turns = _sigrid_turns(torch, ids, salt, max_value)
    rows[0].update(turns_ms=turns, same_bytes_ms=statistics.median(turns["same_bytes"]))
    print(f"[kernel] sigrid_hash {rows[0]['shape']}: the kernel and the same-bytes "
          f"torch.bitwise_xor in turns {json.dumps(turns)}", flush=True)
    ids8 = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, (
        8 * BATCH, ids.shape[1]), dtype=np.int64).astype(np.int32)).cuda()
    if not torch.equal(ksigrid.sigrid_hash(ids8, salt, max_value),
                       ref.sigrid_hash(ids8, salt, max_value)):
        raise RuntimeError(f"sigrid_hash at {tuple(ids8.shape)} differs")
    rows[0]["batch8"] = dict(shape=list(ids8.shape),
                             bound_ms=8 * ids8.numel() / HBM_BYTES_PER_S * 1e3,
                             turns_ms=_sigrid_turns(torch, ids8, salt, max_value))
    print(f"[kernel] sigrid_hash 8-batch tile, bit-exact, in turns: "
          f"{json.dumps(rows[0]['batch8'])}", flush=True)
    return rows


def _sigrid_turns(torch, ids, salt, max_value):
    """``sigrid_hash`` and ``torch.bitwise_xor(ids, salt)`` (the same bytes
    with one op) in turns, three times each way round."""
    from repro_torch.kernels import sigrid_hash as ksigrid

    fns = {"sigrid_hash": lambda: ksigrid.sigrid_hash(ids, salt, max_value),
           "same_bytes": lambda: torch.bitwise_xor(ids, salt)}
    turns = {name: [] for name in fns}
    for t in range(6):
        for name in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            turns[name].append(_queued_ms(torch, fns[name]))
    return turns


def _bucketize_more_borders(torch, dense):
    """``bucketize`` on the same dense tile with other borders, bit-exact and
    timed beside ``torch.bucketize`` where the borders are sorted: 63 sorted
    borders with ties (runs of equal borders and -0.0/+0.0 pairs), 5,000
    sorted ones and 5,000 unsorted ones (past the 4,096 the first kernel
    held in shared memory)."""
    import numpy as np

    from repro_torch.kernels import bucketize as kbucketize
    from repro_torch.kernels import ref

    rng = np.random.default_rng(23)
    lin = np.linspace(-3, 3, 63).astype(np.float32)
    ties = np.sort(np.concatenate([lin[:36], np.repeat(lin[36:43], 3),
                                   [-0.0, 0.0, -0.0, 0.0, 0.0, -0.0]]).astype(np.float32),
                   kind="stable")
    many = rng.standard_normal(5000).astype(np.float32) * 2
    cases = {"63 with ties": ties, "5000 sorted": np.sort(many), "5000 unsorted": many}
    out = {}
    for name, b in cases.items():
        bd = torch.from_numpy(b).cuda()
        want = ref.bucketize(dense, bd)
        if not torch.equal(kbucketize.bucketize(dense, bd), want):
            raise RuntimeError(f"bucketize: {name} borders differ from the plain version")
        sorted_ = bool((bd[:-1] <= bd[1:]).all())
        ok = ~torch.isnan(dense)
        if sorted_ and not torch.equal(torch.bucketize(dense, bd, out_int32=True)[ok], want[ok]):
            raise RuntimeError(f"bucketize: torch.bucketize disagrees on {name} borders")
        out[name] = dict(
            ms=_queued_ms(torch, lambda: kbucketize.bucketize(dense, bd)),
            library_ms=(_queued_ms(torch, lambda: torch.bucketize(dense, bd, out_int32=True))
                        if sorted_ else None))
    print(f"[kernel] bucketize other borders on the same tile, bit-exact: {json.dumps(out)}",
          flush=True)
    return out


def _standalone_adversarial_checks(torch) -> None:
    """``sigrid_hash`` and ``bucketize`` bit-exact on inputs the data path
    never makes: INT_MIN, -1 and 0 ids, salts 0 and 2^32-1, max_value 1,
    2, 3, 2^16+1, 2,000,000, 2^31-1, 2^31, 2^31+5, 2^32-2 and 2^32-1
    (remainders above INT_MAX wrap negative), odd and unaligned tiles;
    NaN, infinite, subnormal and signed-zero values tied with borders, NaN
    and unsorted borders, sorted borders with ties, 0, 1, 1000 and 5000
    borders (sorted and unsorted)."""
    import numpy as np

    from repro_torch.kernels import bucketize as kbucketize
    from repro_torch.kernels import ref
    from repro_torch.kernels import sigrid_hash as ksigrid

    rng = np.random.default_rng(22)
    ids = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, 70_001, dtype=np.int64)
                           .astype(np.int32)).cuda()
    ids[:4] = torch.tensor([-(2 ** 31), -1, 0, 2 ** 31 - 1], dtype=torch.int32)
    negative = False
    for t in (ids, ids[1:], ids[:70_000].view(350, 200), ids[:1]):
        for salt in (0, 2 ** 32 - 1):
            for mv in (1, 2, 3, 2 ** 16 + 1, 2_000_000, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 5,
                       2 ** 32 - 2, 2 ** 32 - 1):
                got = ksigrid.sigrid_hash(t, salt, mv)
                if not torch.equal(got, ref.sigrid_hash(t, salt, mv)):
                    raise RuntimeError(f"sigrid_hash {tuple(t.shape)} salt {salt} "
                                       f"max_value {mv} differs")
                negative |= bool((got < 0).any())
    if not negative:
        raise RuntimeError("sigrid_hash: no remainder above INT_MAX wrapped negative")
    print("[adversarial] sigrid_hash INT_MIN/-1/0, salts 0 and 2^32-1, max_value 1, 2, 3, "
          "2^16+1, 2e6, 2^31-1, 2^31, 2^31+5, 2^32-2, 2^32-1, unaligned and odd tiles: "
          "bit-exact", flush=True)

    v = torch.from_numpy((rng.standard_normal(50_001) * 3).astype(np.float32)).cuda()
    v[:9] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-40,
                          -1e-40, 1.0, -1.0])
    borders = {
        "none": torch.zeros(0), "one": torch.tensor([0.0]),
        "signed zeros": torch.tensor([-0.0, 0.0, 1e-40, 1.0]),
        "NaN": torch.tensor([-1.0, float("nan"), 0.5, float("nan")]),
        "unsorted": torch.tensor([2.0, -1.0, 0.0, -float("inf"), float("inf"), 0.5]),
        "1000": torch.from_numpy(np.sort(rng.standard_normal(1000).astype(np.float32))),
        "ties": torch.tensor([-2.0, -1.0, -1.0, -1.0, -0.0, 0.0, -0.0, 0.0, 1e-40, 1.0, 1.0]),
        "5000 sorted": torch.from_numpy(np.sort(rng.standard_normal(5000).astype(np.float32))
                                        .round(1)),
        "5000 unsorted": torch.from_numpy(rng.standard_normal(5000).astype(np.float32)),
    }
    for name, bd in borders.items():
        bd = bd.cuda()
        for t in (v, v[1:], v[2:], v[:50_000].view(100, 500)):
            if not torch.equal(kbucketize.bucketize(t, bd), ref.bucketize(t, bd)):
                raise RuntimeError(f"bucketize {name} borders {tuple(t.shape)} differs")
    print("[adversarial] bucketize NaN/inf/subnormal/signed-zero values, aligned and "
          "unaligned tiles; no, one, signed-zero, NaN, unsorted, 1000 sorted, tied, and 5000 "
          "sorted and unsorted borders: bit-exact", flush=True)


def _ssd_bound(x, b_, chunk):
    """The least time of one SSD launch: bytes (x, dt, A, B, C read once,
    y and the (B, H, P, N) float32 state written once) at 3.35 TB/s against
    the operations of the chunked form with the causal half of each
    chunk's Q x Q products only (C.B^T and m.x over the lower triangle,
    C.state and the state update in full) at the bf16 tensor peak.
    Returns (ms, bound_by, flops, bytes)."""
    bsz, s, h, p = x.shape
    n = b_.shape[3]
    flops = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        flops += q * (q + 1) // 2 * 2 * (n + p) + 4 * q * n * p
    flops *= bsz * h
    nbytes = (2 * x.numel() * x.element_size() + 2 * b_.numel() * b_.element_size()
              + 4 * bsz * s * h + 4 * h + 4 * bsz * h * p * n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), flops, nbytes


def _ssd_close(got, want, tol):
    """The largest |got - want| in units of rms(want), and the largest share
    of its per-element bound ``atol * rms(want) + rtol * |want|`` that an
    element uses (within tolerance: a share of at most 1)."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    rms = float(want.square().mean().sqrt())
    diff = (got - want).abs()
    share = diff / (atol * rms + rtol * want.abs())
    return float(diff.max()) / rms, float(share.max())


def _ssm_serve_path(torch):
    """Full-width mamba2-2.7b through the port's serve path on the card, with
    the launch counts set to 0 just before and read just after; then a
    short profiled decode window, the SSD operands of layers 0 and 63 from
    another prefill, and the full-width BatchingServer.  Returns the
    launches, the captured operands and the path's numbers."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import BatchingServer, Request, ServerConfig

    s_cfg = CONFIG.ssm
    t = time.perf_counter()
    model = build_model(CONFIG, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[ssm] {CONFIG.name}: {n_params} parameters ({param_bytes / 1e9:.3f} GB) drawn "
          f"on the card in {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=2,
                cache_len=LM_CACHE)
    print(f"[ssm] first call (prefill + 2 decode steps) {time.perf_counter() - t:.2f} s",
          flush=True)

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.reset()
    out = serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=LM_DECODE,
                      cache_len=LM_CACHE)
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    print(f"[ssm] main path launches {launches}", flush=True)
    if launches != {"ssd_chunk_forward_sm90": CONFIG.num_layers}:
        raise RuntimeError(f"the prefill launched {launches}, expected the tensor-core "
                           f"ssd_chunk_forward_sm90 {CONFIG.num_layers} times, the FMA "
                           "route's ssd_chunk_forward not once, and nothing else")
    if not torch.isfinite(out["logits"].float()).all():
        raise RuntimeError("non-finite logits")
    tokens = out["tokens"]
    if (tuple(tokens.shape) != (LM_BATCH, 1 + LM_DECODE) or int(tokens.min()) < 0
            or int(tokens.max()) >= CONFIG.vocab_size):
        raise RuntimeError(f"bad sampled tokens {tuple(tokens.shape)}")
    print(f"[ssm] serve: prefill_s={out['prefill_s']:.6f} decode_s={out['decode_s']:.6f} "
          f"decode_tok_per_s={out['decode_tok_per_s']:.3f} peak device memory "
          f"{peak / 1e9:.3f} GB, finite logits, sampled tokens[0] "
          f"{tokens[0, :16].tolist()}", flush=True)

    # one short profiled decode window: device ops and busy time a step
    window = 4
    cache = model.init_cache(LM_BATCH, LM_CACHE)
    token = tokens[:, :1].to("cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(window):
            logits, cache = model.decode_step({"token": token, "pos": i, "cache": cache})
            token = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    by_name, device_ops = _device_by_name(torch, prof)
    busy = sum(by_name.values()) / 1e6 if by_name else None
    ops_per_step = device_ops / window if by_name else None
    busy_per_step = busy / window if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[ssm] profiled decode window of {window} steps: {window_s:.6f} s wall, device "
          f"busy {_fmt(busy, '.6f')} s, idle share {_fmt(_idle_share(busy, window_s), '.5f')}, "
          f"{_fmt(ops_per_step, '.0f')} device kernels and copies a step (profile and "
          f"summary {time.perf_counter() - t:.2f} s)", flush=True)
    del cache, logits

    # bounds: decode reads every weight but the token table (B rows of it)
    # and reads and writes the state and conv tails; the prefill's
    # projections and logits at the bf16 peak, plus the SSD's operations
    tok_bytes = model.embed.tok.numel() * model.embed.tok.element_size()
    cache_bytes = sum(math.prod(shape) * (torch.finfo(dtype).bits // 8)
                      for shape, dtype in model.abstract_cache(LM_BATCH, 0).values())
    step_bytes = param_bytes - tok_bytes + LM_BATCH * CONFIG.d_model * 2 + 2 * cache_bytes
    decode_bound = LM_BATCH / (step_bytes / HBM_BYTES_PER_S)
    d, din = CONFIG.d_model, s_cfg.d_inner(CONFIG.d_model)
    h, gn = s_cfg.n_heads(CONFIG.d_model), s_cfg.n_groups * s_cfg.d_state
    proj_flops = (2 * LM_BATCH * LM_PROMPT * CONFIG.num_layers
                  * (d * (2 * din + 2 * gn + h) + din * d)
                  + 2 * LM_BATCH * d * CONFIG.vocab_size)

    # the SSD operands of layers 0 and 63, from another prefill: what
    # ssd_chunked hands to kernels.ops
    captured = []
    original = ops.ssd_chunk_forward

    def capture(x, dt, a, b_, c_, **kw):
        if len(captured) in SSM_CAPTURE_LAYERS:
            captured.append(tuple(t.clone() for t in (x, dt, a, b_, c_)))
        else:
            captured.append(None)
        return original(x, dt, a, b_, c_, **kw)

    ops.ssd_chunk_forward = capture
    t = time.perf_counter()
    try:
        serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=0,
                    cache_len=LM_CACHE)
    finally:
        ops.ssd_chunk_forward = original
    operands = {i: captured[i] for i in SSM_CAPTURE_LAYERS}
    print(f"[ssm] operands of layers {SSM_CAPTURE_LAYERS} captured in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    x, _, _, b_, _ = operands[SSM_CAPTURE_LAYERS[0]]
    _, _, ssd_flops, _ = _ssd_bound(x, b_, s_cfg.chunk)
    prefill_bound = (proj_flops + CONFIG.num_layers * ssd_flops) / BF16_OPS_PER_S
    numbers = {
        "config": CONFIG.name, "parameters": n_params, "param_bytes": param_bytes,
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "decode_steps": LM_DECODE,
        "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
        "decode_tok_per_s": out["decode_tok_per_s"],
        "ssd_chunk_forward_sm90_launches": launches.get("ssd_chunk_forward_sm90", 0),
        "ssd_chunk_forward_launches": launches.get("ssd_chunk_forward", 0),
        "peak_device_bytes": peak, "prefill_projection_flops": proj_flops,
        "prefill_ssd_flops": CONFIG.num_layers * ssd_flops,
        "prefill_bound_s": prefill_bound, "decode_step_bytes": step_bytes,
        "decode_bound_tok_per_s": decode_bound, "profiled_window_steps": window,
        "profiled_window_s": window_s, "decode_device_busy_s_per_step": busy_per_step,
        "decode_device_ops_per_step": ops_per_step,
        "decode_device_idle_share": _idle_share(busy, window_s),
        "decode_device_top_us": {k[:80]: v for k, v in top},
        "sampled_tokens_0": tokens[0, :16].tolist(),
    }
    print(f"[ssm] bounds: prefill {prefill_bound * 1e3:.3f} ms ({proj_flops} projection "
          f"flops + {CONFIG.num_layers * ssd_flops} SSD flops at the bf16 peak), decode "
          f"{decode_bound:.1f} tokens/s ({step_bytes} bytes a step)", flush=True)
    del captured, model, out
    torch.cuda.empty_cache()

    t = time.perf_counter()
    server = BatchingServer(CONFIG, ServerConfig(slots=4, cache_len=LM_CACHE), seed=0,
                            device="cuda")
    print(f"[ssm] BatchingServer built in {time.perf_counter() - t:.2f} s", flush=True)
    rng = np.random.default_rng(1)
    for rid in range(4):
        server.submit(Request(rid=rid, prompt=rng.integers(0, CONFIG.vocab_size, 16)
                              .astype(np.int32), max_new_tokens=8))
    t0 = time.perf_counter()
    done = server.run()
    server_s = time.perf_counter() - t0
    if len(done) != 4 or any(len(r.output) != 8 for r in done) or any(
            not 0 <= tok < CONFIG.vocab_size for r in done for tok in r.output):
        raise RuntimeError(f"BatchingServer finished {[len(r.output) for r in done]}")
    report = BatchingServer.latency_report(done)
    print(f"[ssm] BatchingServer: 4 requests in {server_s:.3f} s, latency_report "
          f"{json.dumps(report)}", flush=True)
    numbers["server"] = {"slots": 4, "requests": 4, "prompt_len": 16, "new_tokens": 8,
                         "run_s": server_s, "latency_report": report,
                         "outputs": {r.rid: r.output for r in done}}
    del server
    torch.cuda.empty_cache()
    return launches, operands, numbers


def _ssd_checks(torch, operands, launches):
    """``ssd_chunk_forward`` at the main path's operands (layers 0 and 63):
    in bf16 as the path runs it, through the tensor-core route the
    operands pick and through the FMA route, and on the same operands cast
    to float32 (the FMA route), y and the final state against the plain
    version (the sequential float32 recurrence) within ``SSD_TOL``; each
    route's largest share of the per-element bound is printed.  Then times
    of both routes and the plain version beside the bound (layer 0's bf16
    operands), and the two routes again in turns: one row for each route.
    The plain version's 1024 positions take ~9 small launches each, more
    than can be queued behind a sleep, so its time is a call time (CUDA
    events around back-to-back calls)."""
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as kssd

    chunk = CONFIG.ssm.chunk
    routes = (("ssd_chunk_forward_sm90", "src/repro_torch/csrc/ssd_chunk_sm90.cu",
               kssd.ssd_chunk_forward_sm90),
              ("ssd_chunk_forward", "src/repro_torch/csrc/ssd_chunk.cu",
               kssd.ssd_chunk_forward_fma))
    worst = {name: 0.0 for name, _, _ in routes}
    shares = {name: 0.0 for name, _, _ in routes}
    for layer, ops_ in sorted(operands.items()):
        x, dt, a, b_, c_ = ops_
        if kssd.route(x, b_, c_, chunk) != "sm90":
            raise RuntimeError(f"layer {layer}'s SSD operands do not take the tensor-core route")
        for name, fn in [(n, f) for n, _, f in routes] + [("float32", kssd.ssd_chunk_forward)]:
            args = (x, b_, c_) if name != "float32" else (x.float(), b_.float(), c_.float())
            dtype = "float32" if name == "float32" else "bfloat16"
            xx, bb, cc = args
            y, state = fn(xx, dt, a, bb, cc, chunk=chunk)
            want_y, want_state = ref.ssd_scan(xx, dt, a, bb, cc)
            torch.cuda.synchronize()
            if not (torch.isfinite(y.float()).all() and torch.isfinite(state).all()):
                raise RuntimeError(f"{name} layer {layer} {dtype}: not finite")
            err_y, share_y = _ssd_close(y, want_y, SSD_TOL[dtype])
            err_s, share_s = _ssd_close(state, want_state, SSD_TOL["float32"])
            if max(share_y, share_s) > 1:
                raise RuntimeError(f"{name} layer {layer} {dtype}: y {err_y:.3e} of rms(y), "
                                   f"state {err_s:.3e} of rms(state); shares of the bound "
                                   f"{share_y:.3f}, {share_s:.3f}")
            if name in worst:
                worst[name] = max(worst[name], err_y)
                shares[name] = max(shares[name], share_y, share_s)
            label = "ssd_chunk_forward (FMA route)" if name == "float32" else name
            print(f"[kernel] {label} layer {layer} {dtype} x {tuple(x.shape)} B/C "
                  f"{tuple(b_.shape)}: max |kernel - plain| y {err_y:.3e} rms(y), state "
                  f"{err_s:.3e} rms(state); largest share of the per-element bound "
                  f"atol*rms + rtol*|want| {SSD_TOL[dtype]} {share_y:.3f} (y), "
                  f"{SSD_TOL['float32']} {share_s:.3f} (state); rms(y) "
                  f"{float(want_y.float().square().mean().sqrt()):.4e}, rms(state) "
                  f"{float(want_state.square().mean().sqrt()):.4e}, dt max "
                  f"{float(dt.max()):.2f}", flush=True)
            del y, state, want_y, want_state
    print(f"[kernel] ssd_chunk_forward at layers {SSM_CAPTURE_LAYERS}, bf16: each route's "
          f"largest share of the per-element bound (y or state) {json.dumps(shares)}",
          flush=True)

    x, dt, a, b_, c_ = operands[SSM_CAPTURE_LAYERS[0]]
    plain = lambda: ref.ssd_scan(x, dt, a, b_, c_)
    bound_ms, bound_by, flops, nbytes = _ssd_bound(x, b_, chunk)
    plain_ms = _call_ms(torch, plain, iters=3)
    shape = (f"x {tuple(x.shape)} B/C {tuple(b_.shape)} bf16 chunk {chunk} "
             f"(layer {SSM_CAPTURE_LAYERS[0]} of the mamba2-2.7b prefill)")
    rows = []
    for name, source, fn in routes:
        kernel = lambda fn=fn: fn(x, dt, a, b_, c_, chunk=chunk)
        row = dict(
            name=name, route="cuda", source=source,
            replaces="src/repro/kernels/ssd_chunk.py:67", shape=shape,
            launches=launches.get(name, 0), max_abs_err=worst[name],
            ms=_queued_ms(torch, kernel), plain_ms=plain_ms, plain_timed_by="call",
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            call_ms=_call_ms(torch, kernel, iters=20), plain_call_ms=plain_ms,
            library_call_ms=None,
        )
        rows.append(row)
        print(f"[kernel] {name} {shape}: kernel_ms={row['ms']:.6f} plain_ms={plain_ms:.6f} "
              f"(call time) library_ms=None bound_ms={bound_ms:.6f} ({bound_by}: {flops} "
              f"flops, {nbytes} bytes) call_ms={row['call_ms']:.6f}", flush=True)
    # the two routes again, in turns, for the spread within this run
    turns = {name: [] for name, _, _ in routes}
    for _ in range(3):
        for name, _, fn in routes:
            turns[name].append(_queued_ms(torch, lambda fn=fn: fn(x, dt, a, b_, c_, chunk=chunk)))
    rows[0]["turns_ms"] = turns
    print(f"[kernel] ssd_chunk_forward's two routes in turns: {json.dumps(turns)}", flush=True)
    return rows


def _ssd_adversarial_checks(torch) -> None:
    """``ssd_chunk_forward`` against its plain version on inputs the main
    path never makes, through whichever route each takes: S of 1, 63, 256,
    300 and 1000 (ragged last chunks, one position); groups 1, 2 and 8; P
    and N of 16, 64 and 128; dt large enough that cs reaches -1e4 in a
    chunk (every exp underflows but the diagonal's); A = 0 (no decay at
    all); an initial state; float32 and bf16, y and the final state within
    ``SSD_TOL``.  Then bf16 cases that must take the tensor-core route:
    ragged S of 1, 63, 300 and 1000, G of 2 and 8, P of 128, N of 64,
    chunks of 64 and 128, dt*A ~ -40, A = 0 and an initial state."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as kssd

    gen = torch.Generator(device="cuda").manual_seed(14)
    # (B, S, H, P, G, N, chunk, kind)
    cases = ((1, 1, 8, 64, 1, 128, 256, "normal"), (2, 63, 8, 16, 2, 16, 256, "normal"),
             (1, 256, 16, 64, 8, 64, 256, "normal"), (2, 300, 8, 128, 2, 128, 256, "normal"),
             (1, 1000, 8, 64, 1, 128, 256, "normal"), (2, 130, 4, 16, 1, 64, 64, "normal"),
             (1, 512, 4, 64, 1, 64, 256, "large dt"), (1, 300, 4, 32, 2, 32, 128, "A = 0"),
             (2, 200, 8, 64, 2, 128, 256, "initial state"))
    sm90_cases = ((1, 1, 8, 64, 1, 128, 256, "normal"), (2, 63, 8, 64, 1, 128, 64, "normal"),
                  (2, 300, 8, 64, 2, 128, 256, "normal"),
                  (1, 1000, 16, 64, 8, 64, 128, "normal"),
                  (2, 300, 4, 128, 1, 128, 128, "normal"),
                  (1, 512, 4, 64, 1, 64, 256, "large dt"), (1, 300, 4, 64, 2, 128, 64, "A = 0"),
                  (2, 200, 8, 128, 2, 64, 256, "initial state"))
    taken = {"sm90": 0, "fma": 0}
    for dtype, case_list, must in ((torch.float32, cases, None), (torch.bfloat16, cases, None),
                                   (torch.bfloat16, sm90_cases, "sm90")):
        name = str(dtype).split(".")[-1]
        for bsz, s, h, p, g, n, chunk, kind in case_list:
            x = (torch.randn((bsz, s, h, p), generator=gen, device="cuda") * 0.5).to(dtype)
            dt = torch.nn.functional.softplus(torch.randn((bsz, s, h), generator=gen,
                                                          device="cuda"))
            a = -torch.exp(torch.randn(h, generator=gen, device="cuda") * 0.3)
            bm = (torch.randn((bsz, s, g, n), generator=gen, device="cuda") * 0.5).to(dtype)
            cm = (torch.randn((bsz, s, g, n), generator=gen, device="cuda") * 0.5).to(dtype)
            init = None
            if kind == "large dt":                 # dt*A ~ -40 a position
                dt = dt + 40.0
                a = -torch.ones_like(a)
            elif kind == "A = 0":
                a = torch.zeros_like(a)
            elif kind == "initial state":
                init = torch.randn((bsz, h, p, n), generator=gen, device="cuda")
            route = kssd.route(x, bm, cm, chunk)
            if must is not None and route != must:
                raise RuntimeError(f"ssd_chunk_forward {kind} (P={p}, N={n}, chunk {chunk}) "
                                   f"{name}: route {route}, expected {must}")
            taken[route] += 1
            y, state = kssd.ssd_chunk_forward(x, dt, a, bm, cm, chunk=chunk,
                                              initial_state=init)
            want_y, want_state = ref.ssd_scan(x, dt, a, bm, cm, init)
            torch.cuda.synchronize()
            if not (torch.isfinite(y.float()).all() and torch.isfinite(state).all()):
                raise RuntimeError(f"ssd_chunk_forward {kind} S={s} {name}: not finite")
            err_y, share_y = _ssd_close(y, want_y, SSD_TOL[name])
            err_s, share_s = _ssd_close(state, want_state, SSD_TOL["float32"])
            if max(share_y, share_s) > 1:
                raise RuntimeError(f"ssd_chunk_forward ({route} route) {kind} (B={bsz}, S={s}, "
                                   f"H={h}, P={p}, G={g}, N={n}, chunk {chunk}) {name}: y "
                                   f"{err_y:.3e} rms(y), state {err_s:.3e} rms(state), shares "
                                   f"{share_y:.3f}, {share_s:.3f}")
    print(f"[adversarial] ssd_chunk_forward S in (1, 63, 130, 200, 256, 300, 512, 1000), "
          f"G in (1, 2, 8), P and N in (16, 32, 64, 128), chunks 64/128/256, dt*A ~ -40 "
          f"(|cs| to 1e4), A = 0, an initial state, f32 and bf16, through the route each "
          f"takes ({taken['sm90']} cases on the tensor-core route, {taken['fma']} on the FMA "
          f"route): within tolerance", flush=True)


def _ssm_card_vs_cpu(torch):
    """A depth-2, full-width mamba2-2.7b from one set of weights (drawn on
    the card from seed 1) on the card and on the CPU: prefill of 2 prompts
    of 512 tokens (2 chunks), then 4 greedy decode steps.  float32: every
    call's logits within 1e-3 of their rms, greedy tokens equal; bf16:
    within 10% of their rms, both sides fed the CPU's tokens (bf16 logits
    of a random model tie often), and whether the card's greedy tokens
    equal the CPU's is printed.  The prefill's final state and conv tails
    are held to the same bounds in relative norm, ||card - cpu|| / ||cpu||:
    the state is heavy-tailed (its largest element ~50x its rms) and each
    element depends exponentially on dt, which reaches 150 at these random
    weights, so one rounding of dt's projection that differs between the
    devices moves single elements by far more than the rms (bf16: 1.5x the
    rms on an H100) while the tensor as a whole, and the decode
    steps that read it, stay close.  The largest |diff| over the rms is
    printed for each, and the largest relative norm of one (layer, batch
    row, head) of the state.

    That the per-element gap comes from the operands and not from the
    scan is checked per element: each layer's scan, fed on the CPU the
    card's own operands (x, dt, A, B, C as the card's projections, convs
    and softplus made them), gives the card's y and final state within
    ``SSD_TOL`` (the state at the float32 bound), and how far the card's
    operands sit from the CPU's is printed.  A fault of the kernel in one
    head would show there, undiluted by the other 79."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.models import build_model, ssm

    scan = ssm.ssd_chunked

    def prefill_capturing(model, scans):
        """The model's prefill, each layer's scan operands and outputs
        copied to the host."""
        def capture(x, dt, a, b_, c_, chunk, initial_state=None):
            y, state = scan(x, dt, a, b_, c_, chunk, initial_state)
            scans.append(([t.to("cpu", copy=True) for t in (x, dt, a, b_, c_)],
                          y.to("cpu", copy=True), state.to("cpu", copy=True)))
            return y, state

        ssm.ssd_chunked = capture
        try:
            return model.prefill({"tokens": prompt})
        finally:
            ssm.ssd_chunked = scan

    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, CONFIG.vocab_size, (2, 512)).astype(np.int32))
    result = {}
    for name, dtype, tol in (("float32", torch.float32, 1e-3),
                             ("bfloat16", torch.bfloat16, 0.1)):
        cfg = dataclasses.replace(CONFIG, num_layers=2, param_dtype=dtype, compute_dtype=dtype)
        card = build_model(cfg, device="cuda").init(1)
        cpu = build_model(cfg, device="cpu")
        cpu.load_state_dict(card.state_dict())
        t0 = time.perf_counter()
        c_scans, g_scans = [], []
        c_logits, c_cache = prefill_capturing(cpu, c_scans)
        c_steps, c_toks = [c_logits.float()], [torch.argmax(c_logits, dim=-1).to(torch.int32)]
        cache = {k: v.clone() for k, v in c_cache.items()}
        for pos in range(4):
            lg, cache = cpu.decode_step({"token": c_toks[-1], "pos": pos, "cache": cache})
            c_steps.append(lg.float())
            c_toks.append(torch.argmax(lg, dim=-1).to(torch.int32))
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        g_logits, g_cache = prefill_capturing(card, g_scans)
        g_steps, g_toks = [g_logits.float().cpu()], [torch.argmax(g_logits, dim=-1).cpu()]
        g_prefill_cache = {k: v.to("cpu", torch.float32, copy=True) for k, v in g_cache.items()}
        cache = g_cache
        for pos in range(4):
            token = (g_toks[-1] if name == "float32" else c_toks[pos]).to(torch.int32)
            lg, cache = card.decode_step({"token": token, "pos": pos, "cache": cache})
            g_steps.append(lg.float().cpu())
            g_toks.append(torch.argmax(lg, dim=-1).cpu().to(torch.int32))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        del card, cpu, cache, g_cache
        torch.cuda.empty_cache()
        rel = lambda g, c: float((g.float() - c.float()).abs().max()
                                 / c.float().square().mean().sqrt())
        rel_norm = lambda g, c: float((g.float() - c.float()).norm() / c.float().norm())
        logit_rel = [rel(g, c) for g, c in zip(g_steps, c_steps)]
        cache_rel = {k: rel(g_prefill_cache[k], c_cache[k]) for k in sorted(c_cache)}
        cache_norm = {k: rel_norm(g_prefill_cache[k], c_cache[k]) for k in sorted(c_cache)}
        same = bool(torch.equal(torch.cat(g_toks, 1).to(torch.int32),
                                torch.cat(c_toks, 1).to(torch.int32)))
        # ||card - cpu|| / ||cpu|| of each (layer, batch row, head) of the state
        g_state, c_state = g_prefill_cache["state"], c_cache["state"].float()
        head_norm = float(((g_state - c_state).flatten(3).norm(dim=-1)
                           / c_state.flatten(3).norm(dim=-1)).max())
        witness = []
        for layer, ((g_ops, g_y, g_s), (c_ops, _, _)) in enumerate(zip(g_scans, c_scans)):
            w_y, w_s = scan(*g_ops, CONFIG.ssm.chunk)
            err_y, share_y = _ssd_close(g_y, w_y, SSD_TOL[name])
            err_s, share_s = _ssd_close(g_s, w_s, SSD_TOL["float32"])
            if max(share_y, share_s) > 1:
                raise RuntimeError(f"card vs CPU {name} layer {layer}: the card's scan "
                                   f"against the CPU's on the card's operands: y {err_y:.3e}, "
                                   f"state {err_s:.3e} of the rms; shares of the bound "
                                   f"{share_y:.3f}, {share_s:.3f}")
            gdt, cdt = g_ops[1], c_ops[1]
            witness.append({
                "layer": layer, "y_max_diff_over_rms": err_y, "y_share": share_y,
                "state_max_diff_over_rms": err_s, "state_share": share_s,
                "dt_max": float(cdt.max()), "dt_max_abs_diff": float((gdt - cdt).abs().max()),
                "operand_share_differing": {
                    k: float((g != c).float().mean())
                    for k, g, c in zip(("x", "dt", "B", "C"), (g_ops[0], gdt, *g_ops[3:]),
                                       (c_ops[0], cdt, *c_ops[3:]))}})
        del g_scans, c_scans
        result[name] = {"logits_max_diff_over_rms": logit_rel,
                        "prefill_cache_rel_norm": cache_norm,
                        "prefill_cache_max_diff_over_rms": cache_rel,
                        "state_worst_head_rel_norm": head_norm,
                        "scan_on_card_operands": witness,
                        "greedy_tokens_equal": same, "card_s": card_s, "cpu_s": cpu_s}
        if max(logit_rel + list(cache_norm.values())) > tol:
            raise RuntimeError(f"card vs CPU {name}: logits {logit_rel} of their rms, prefill "
                               f"cache {cache_norm} in relative norm, bound {tol}")
        if name == "float32" and not same:
            raise RuntimeError(f"card vs CPU float32 greedy tokens differ: "
                               f"{torch.cat(g_toks, 1).tolist()} vs {torch.cat(c_toks, 1).tolist()}")
        print(f"[ssm] card vs CPU, depth 2 full width, prompt 512, {name}: logits per call "
              f"{['%.3e' % r for r in logit_rel]} (max |diff| over rms), prefill cache "
              f"{ {k: '%.3e' % v for k, v in cache_norm.items()} } (relative norm; bound "
              f"{tol}); prefill cache max |diff| over rms "
              f"{ {k: '%.3e' % v for k, v in cache_rel.items()} }; worst (layer, row, head) "
              f"of the state {head_norm:.3e} (relative norm); greedy tokens equal: "
              f"{same}; card {card_s:.2f} s, CPU {cpu_s:.2f} s", flush=True)
        for w in witness:
            print(f"[ssm] card vs CPU {name} layer {w['layer']}: the CPU's scan on the card's "
                  f"operands gives the card's y within {w['y_max_diff_over_rms']:.3e} and its "
                  f"state within {w['state_max_diff_over_rms']:.3e} of the rms (shares of the "
                  f"per-element bound {w['y_share']:.3f}, {w['state_share']:.3f}); the card's "
                  f"operands against the CPU's: dt (max {w['dt_max']:.2f}) differs by up to "
                  f"{w['dt_max_abs_diff']:.4g}, share of elements differing "
                  f"{ {k: '%.3e' % v for k, v in w['operand_share_differing'].items()} }",
                  flush=True)
    return result


def main() -> int:
    torch, card = _setup()
    import numpy as np

    from repro_torch.kernels import build

    t_all = t = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        build.build(verbose=True)
    print(log.getvalue(), end="", flush=True)
    build.library()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    for line in _ptxas_summary(log.getvalue(), PTXAS_KERNELS):
        print(f"[ptxas] {line}", flush=True)
    t = time.perf_counter()
    _warm_profiler(torch)
    print(f"[profiler] first session {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    operands, waves = _capture_operands(torch)
    results = _kernel_checks(torch, operands, waves)
    _adversarial_checks(torch)
    _bag_adversarial_checks(torch)
    print(f"[phase] data-path kernel checks and adversarial inputs "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    standalone = _standalone_checks(torch, operands)
    _standalone_adversarial_checks(torch)
    print(f"[phase] sigrid_hash and bucketize checks {time.perf_counter() - t:.1f} s",
          flush=True)

    # the serving path: counts set to 0 just before, read just after
    t = time.perf_counter()
    build.LAUNCHES.reset()
    batches, session, serve_s, _ = _serve(torch, "torch")
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"[serve] main path launches {launches}", flush=True)
    for name in ("xor_decrypt", "dense_unpack_warp", "ragged_gather_vec",
                 "fused_transform_vec"):
        if launches.get(name, 0) <= 0:
            raise RuntimeError(f"the main path never launched {name}")
    for general in ("fused_transform", "dense_unpack", "ragged_gather"):
        if launches.get(general, 0) != 0:
            raise RuntimeError(f"the main path launched {general}'s general route "
                               f"{launches[general]} times: every engine operand must "
                               "take the new route")
    n_stripes = sum(len(p.footer.stripes) for p in session.table.partitions.values())
    for name in ("dense_unpack_warp", "ragged_gather_vec"):
        if launches[name] != n_stripes:
            raise RuntimeError(f"the main path launched {name} {launches[name]} times, "
                               f"expected one a stripe ({n_stripes})")
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
        "device_idle_share": _idle_share(device_s, prof_serve_s),
    }}), flush=True)

    for r in results:
        r["launches"] = launches.get(r["name"], 0)
    results.extend(standalone)            # on no path of the port: 0 launches
    print(f"[phase] serving path {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    train_launches, bag_operands, step_bags = _train_path(torch)
    print(f"[phase] trainer path {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    results.extend(_bag_checks(torch, bag_operands, step_bags, train_launches))
    print(f"[phase] embedding_bag checks {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    lm_launches, lm_operands, lm = _lm_serve_path(torch)
    print(f"[phase] LM serving path {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    results.extend(_flash_checks(torch, lm_operands, lm_launches))
    del lm_operands
    torch.cuda.empty_cache()
    _flash_adversarial_checks(torch)
    print(f"[phase] flash_attention checks {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    lm["card_vs_cpu"] = _lm_card_vs_cpu(torch)
    print(json.dumps({"lm": lm}), flush=True)
    print(f"[phase] LM card vs CPU {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    ssm_launches, ssm_operands, ssm = _ssm_serve_path(torch)
    print(f"[phase] SSM serving path {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    results.extend(_ssd_checks(torch, ssm_operands, ssm_launches))
    del ssm_operands
    torch.cuda.empty_cache()
    _ssd_adversarial_checks(torch)
    print(f"[phase] ssd_chunk_forward checks {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    ssm["card_vs_cpu"] = _ssm_card_vs_cpu(torch)
    print(json.dumps({"ssm": ssm}), flush=True)
    print(f"[phase] SSM card vs CPU {time.perf_counter() - t:.1f} s", flush=True)
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
