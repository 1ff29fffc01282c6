"""The program's spans in a traced window of one cell: where the device
time and the idle of a step go, by the span of the program that was open.

    python3 -m dsibench.span_trace --workload <cell> --seed <n> [--seconds 8]

The set-up is a bench run's (the cell's runner, configuration and
traffic).  Then one window of ``--seconds`` (at most the traced run's
``harness.TRACE_SECONDS``) runs under ``torch.profiler`` inside a
``dsibench.window`` annotation, as a bench run's traced window does, but
with a fresh span ``Tracer`` attached to the step (the DLRM cell's
``StepBundle``, the LM cells' ``Trainer``): its spans are profiler
annotations there (``repro_torch.obs.trace``).  The last line of standard
output is one JSON object: the device's busy and window seconds, the
device seconds by the innermost span that launched each operation
(``attribute``), the idle seconds by the innermost span open at each
gap's start, the ten longest gaps named so, the program's host spans and
counters, and ``numbers``, the per-step figures the spans give (one key
a figure, None where the cell has no such span).  The reference's check
is not run: nothing here is compared.
"""
from __future__ import annotations

import gc
import json
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
DLRM_PHASES = ("dlrm.pool", "dlrm.dense", "dlrm.table_update")
DLRM_SPANS = ("step.handoff",) + DLRM_PHASES
ATTENTION = ("attention.fwd", "attention.bwd")


# ---------------------------------------------------------------------------
# the trace by span
# ---------------------------------------------------------------------------


def innermost(spans: List[Tuple[float, float, str]], times: List[float]
              ) -> List[Optional[str]]:
    """For each of ``times``, the name of the shortest of ``spans``
    ((start, end, name), each open on [start, end)) open at it, or None:
    one sweep over the spans' edges and the sorted times."""
    marks = sorted([(a, 1, i) for i, (a, b, _) in enumerate(spans) if b > a]
                   + [(b, 0, i) for i, (a, b, _) in enumerate(spans) if b > a])
    out: List[Optional[str]] = [None] * len(times)
    live: Dict[int, Tuple[float, float, str]] = {}
    j = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(marks) and marks[j][0] <= t:
            _, opens, i = marks[j]
            if opens:
                live[i] = spans[i]
            else:
                live.pop(i, None)
            j += 1
        if live:
            out[k] = min(live.values(), key=lambda sp: sp[1] - sp[0])[2]
    return out


def attribute(ops: List[Tuple[float, float, Any]], launches: Dict[Any, Tuple[Any, float]],
              host: List[Tuple[float, float, str, Any]], lo: float, hi: float
              ) -> Dict[str, float]:
    """The device time within [lo, hi] by the innermost host span that
    launched it: ``ops`` are device intervals (start, end, key), each
    launched at ``launches[key]`` = (thread, time); its span is the
    innermost open on that thread then, else (autograd's device thread
    runs a backward that a span of the calling thread waits on) the
    shortest open on any thread, else "host".  Each instant the device is
    busy is counted once, for the op that started first, so the values
    add up to the union of the ops' intervals."""
    threads: Dict[Any, List[Tuple[float, float, str]]] = {}
    for a, b, name, tid in host:
        threads.setdefault(tid, []).append((a, b, name))
    every = [(a, b, name) for a, b, name, _ in host]
    by_thread: Dict[Any, List[Tuple[int, float]]] = {}
    loose: List[Tuple[int, float]] = []
    for i, (_, _, key) in enumerate(ops):
        launch = launches.get(key)
        if launch is not None:
            by_thread.setdefault(launch[0], []).append((i, launch[1]))
    name: List[Optional[str]] = [None] * len(ops)
    for tid, qs in by_thread.items():
        found = innermost(threads.get(tid, []), [t for _, t in qs])
        for (i, t), n in zip(qs, found):
            if n is None:
                loose.append((i, t))
            name[i] = n
    for (i, _), n in zip(loose, innermost(every, [t for _, t in loose])):
        name[i] = n
    out: Dict[str, float] = {}
    cur = lo
    for i in sorted(range(len(ops)), key=lambda i: ops[i][0]):
        a, b, _ = ops[i]
        a, b = max(a, cur), min(b, hi)
        if b > a:
            n = name[i] or "host"
            out[n] = out.get(n, 0.0) + (b - a)
            cur = b
    return out


def read_spans(prof, program: Iterable[str] = ()) -> Dict[str, Any]:
    """``harness.read_trace``'s busy seconds, window and ten longest
    device operations, with the program's annotations (``program``: the
    names its tracer recorded) told apart from the other CPU events: the
    ten longest idle gaps named by the innermost benchmark or program
    span open at the gap's start, and, over the window, the device
    seconds by the innermost such span that launched each operation
    (``attribute``) and the idle seconds by the innermost span open at
    each gap's start.  ``busy_s`` is None where the profiler recorded no
    device activity."""
    import torch

    from dsibench.harness import SPAN_PREFIX, BenchmarkError, union_seconds

    cuda = torch.autograd.DeviceType.CUDA
    program = set(program)
    device_iv, by_name, host = [], {}, []
    ops, runtime, frontend = [], {}, {}
    win = None
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if ev.device_type == cuda and not ev.name.startswith(SPAN_PREFIX) \
                and ev.name not in program:
            device_iv.append((a, b))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a)
            ops.append((a, b, (ev.id, getattr(ev, "linked_correlation_id", 0))))
        elif ev.device_type == cuda:
            continue        # an annotation's span on the device's timeline
        elif ev.name.startswith(SPAN_PREFIX):
            name = ev.name[len(SPAN_PREFIX):]
            if name == "window":
                win = (a, b)
            else:
                host.append((a, b, name, ev.thread))
        elif ev.name in program:
            host.append((a, b, ev.name, ev.thread))
        elif ev.name.startswith("cu"):       # the CUDA runtime call of a launch or copy
            runtime[ev.id] = (ev.thread, a)
            continue
        frontend[ev.id] = (ev.thread, a)
    if win is None:
        raise BenchmarkError("the trace holds no dsibench.window annotation")
    lo, hi = win
    window_s = (hi - lo) / 1e6
    if not device_iv:
        return {"busy_s": None, "window_s": window_s, "device_ops": [], "idle_gaps": [],
                "device_s_by_span": {}, "idle_s_by_span": {}}
    busy, gaps = union_seconds(device_iv, lo, hi)
    # a device op's launch: its runtime call (the same correlation id),
    # else the CPU op the profiler linked it to (0: none)
    launches = {}
    for _, _, key in ops:
        launch = runtime.get(key[0]) or (frontend.get(key[1]) if key[1] else None)
        if launch is not None:
            launches[key] = launch
    device_s = attribute(ops, launches, host, lo, hi)
    spans = [(a, b, name) for a, b, name, _ in host]
    idle_s: Dict[str, float] = {}
    for (a, b), n in zip(gaps, innermost(spans, [a for a, _ in gaps])):
        idle_s[n or "host"] = idle_s.get(n or "host", 0.0) + (b - a) / 1e6
    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    names = innermost(spans, [a for a, _ in longest])
    ops_top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"busy_s": busy / 1e6, "window_s": window_s,
            "device_ops": [[name[:64], us / 1e6] for name, us in ops_top],
            "idle_gaps": [[n or "host", (b - a) / 1e6] for (a, b), n in zip(longest, names)],
            "device_s_by_span": {k: v / 1e6 for k, v in sorted(device_s.items())},
            "idle_s_by_span": dict(sorted(idle_s.items()))}


def numbers(steps: int, dev: Dict[str, Any], span_s: Dict[str, float],
            counters: Dict[str, float]) -> Dict[str, Optional[float]]:
    """The per-step figures of the window's ``steps`` whole steps:
    ``dev`` is ``read_spans``' result, ``span_s`` the program's host
    seconds by span name, ``counters`` its counters over the window.  A
    figure whose spans or counter the window lacks is None.

    * ``handoff_gb_per_s.dlrm``: ``handoff_bytes`` over the host seconds
      of the ``step.handoff`` spans, in 10^9 B/s;
    * ``pooling_device_ms.dlrm``, ``dense_device_ms.dlrm``,
      ``table_update_device_ms.dlrm``: device ms a step launched inside
      ``dlrm.pool``, ``dlrm.dense``, ``dlrm.table_update``;
    * ``in_step_idle_share.dlrm``: idle whose innermost open span is one
      of those three phases, in % of the traced window;
    * ``dlrm_spans_share_of_busy``: the device seconds of ``step.handoff``
      and the three phases in % of the busy seconds;
    * ``attention_device_ms.lm``: device ms a step launched inside
      ``attention.fwd`` (remat's recompute too) and ``attention.bwd``.
    """
    by_span = dev.get("device_s_by_span") or {}
    idle = dev.get("idle_s_by_span") or {}
    busy, window = dev.get("busy_s"), dev.get("window_s")

    def device_ms(*names):
        if not steps or not any(n in by_span for n in names):
            return None
        return 1e3 * sum(by_span.get(n, 0.0) for n in names) / steps

    handoff = None
    if span_s.get("step.handoff") and "handoff_bytes" in counters:
        handoff = counters["handoff_bytes"] / span_s["step.handoff"] / 1e9
    dlrm = any(n in by_span for n in DLRM_PHASES)
    return {
        "handoff_gb_per_s.dlrm": handoff,
        "pooling_device_ms.dlrm": device_ms("dlrm.pool"),
        "dense_device_ms.dlrm": device_ms("dlrm.dense"),
        "table_update_device_ms.dlrm": device_ms("dlrm.table_update"),
        "in_step_idle_share.dlrm": (100.0 * sum(idle.get(n, 0.0) for n in DLRM_PHASES)
                                    / window) if dlrm and window else None,
        "dlrm_spans_share_of_busy": (100.0 * sum(by_span.get(n, 0.0) for n in DLRM_SPANS)
                                     / busy) if dlrm and busy else None,
        "attention_device_ms.lm": device_ms(*ATTENTION),
    }


# ---------------------------------------------------------------------------
# a session with the program's tracer
# ---------------------------------------------------------------------------


def session_of(cell: str, seed: int, device: str = "cuda",
               overrides: Optional[Dict[str, Any]] = None,
               log: Callable[[str], None] = lambda s: None):
    """A bench run's set-up of ``cell`` (``overrides`` as
    ``harness.run_cell``'s): the runner's session and the object of the
    program a span ``Tracer`` attaches to (``attach_tracer``): the DLRM
    step's bundle or the LM's trainer."""
    from dsibench import harness

    overrides = overrides or {}
    w = harness.workload(harness.manifest(ROOT), cell)
    config = harness.merged(harness.load_json("configs", w["config"]), overrides.get("config"))
    traffic = harness.merged(harness.load_json("traffic", w["traffic"]),
                             overrides.get("traffic"))
    runner = harness.load_module("runners", config["runner"])
    session = runner.setup(config, traffic, seed, device, log)
    return session, getattr(session, "bundle", None) or session.trainer


def handoff_bytes(target) -> Optional[int]:
    """The bytes the step's bundle has handed off so far, None where it
    counts none (the LM's trainer)."""
    counted = getattr(target, "metrics", None)
    return getattr(counted, "handoff_bytes", None)


def traced_window(cell: str, seed: int, seconds: float, device: str = "cuda",
                  overrides: Optional[Dict[str, Any]] = None,
                  log: Callable[[str], None] = lambda s: None) -> Dict[str, Any]:
    """One traced window of ``cell`` with a fresh ``Tracer`` attached to
    the step, read by span (module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from dsibench import harness
    from repro_torch.obs import NULL_TRACER, Tracer

    session, target = session_of(cell, seed, device, overrides, log)
    cuda = torch.device(device).type == "cuda"
    try:
        if cuda:
            harness.warm_profiler(torch)
        gc.collect()
        gc.freeze()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()    # set-up's freed blocks go back, as in a bench run
        window = harness.Window(min(seconds, harness.TRACE_SECONDS), tracing=True)
        tracer = Tracer()
        before = handoff_bytes(target)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        target.attach_tracer(tracer)
        try:
            with profile(activities=acts) as prof:
                with record_function(harness.SPAN_PREFIX + "window"):
                    window.open()
                    session.run_window(window)
                    if cuda:
                        torch.cuda.synchronize()
        finally:
            target.attach_tracer(NULL_TRACER)
        after = handoff_bytes(target)
        counters = {} if before is None else {"handoff_bytes": after - before}
        span_s: Dict[str, float] = {}
        for sp in tracer.spans():
            span_s[sp.name] = span_s.get(sp.name, 0.0) + sp.t1 - sp.t0
        dev = read_spans(prof, span_s)
        del prof
    finally:
        gc.unfreeze()
        session.close_program()
    steps = len(window.steps)
    return {"workload": cell, "seed": seed, "steps": steps, "elapsed_s": window.elapsed,
            "card": torch.cuda.get_device_name(0) if cuda else "cpu",
            "busy_s": dev["busy_s"], "window_s": dev["window_s"],
            "device_s_by_span": dev["device_s_by_span"],
            "idle_s_by_span": dev["idle_s_by_span"], "idle_gaps": dev["idle_gaps"],
            "device_ops": dev["device_ops"],
            "span_s": dict(sorted(span_s.items())), "counters": counters,
            "numbers": numbers(steps, dev, span_s, counters)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from dsibench.run import CACHE_DIRS

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "dsibench" / sub)
    os.environ["USE_FLAX"] = "0"
    out = traced_window(args.workload, args.seed, args.seconds,
                        log=lambda s: print(s, file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
