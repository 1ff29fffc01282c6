"""The harness: finds a cell's files by name, drives its set-up, times the
window, reads the trace, asks the plain reference and prints the result.

Lookups, all by name and none by a list kept here:

* ``BENCHMARK.json`` (the repository root): the cell's configuration and
  traffic names and the metrics it reports;
* ``configs/<config>.json``: the sizes as run, the optimizer, the runner
  (``runners/<runner>.py``) and the plain reference
  (``reference/<reference>.py``);
* ``traffic/<traffic>.json``: the parameters the runner's generator reads;
* ``cells/<cell>.json``: the limits of the numbers compared for
  ``correct``;
* ``metrics/<metric>.py``: one reader a metric, ``read(run)``, which
  returns the value or None where it finds nothing to read.

A runner's ``setup(config, traffic, seed, device)`` builds the program's
state, drives it through its first steps (the ones the reference
follows) and its warm-up, and returns a session with ``units`` ("samples"
or "tokens"), ``run_window(window)``, ``close_program()``, ``check()``
(the numbers compared, worked out once the window has closed) and
``step_counts`` (the frozen counts of one step, for the metric readers).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in the process that prints
# the result: JAX and the JAX package (``repro``; ``repro_torch`` is the port)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# the traced run measures a window of at most this many seconds, so the
# trace stays small enough to read within the run's time limit
TRACE_SECONDS = 8.0
SPAN_PREFIX = "dsibench."


class BenchmarkError(RuntimeError):
    """A run that cannot give a result (no card, a missing file, a metric
    that finds nothing to read where the manifest says it must)."""


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise BenchmarkError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def workload(man: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise BenchmarkError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str, base: Path = HERE) -> Dict[str, Any]:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise BenchmarkError(f"no {kind} file {path.relative_to(base.parent)}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, base: Path = HERE):
    """``<base>/<kind>/<name>.py`` as a module; a name may hold dots and
    dashes, so it is loaded from its path and not imported by name."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise BenchmarkError(f"no {kind} module {path.relative_to(base.parent)}")
    key = f"dsibench._{kind}_{name.replace('.', '_').replace('-', '_')}_{abs(hash(str(path)))}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_of(man: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric without a
    ``workloads`` key is reported in every cell."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def loaded_forbidden(modules=None) -> List[str]:
    """The names in ``sys.modules`` whose top-level name (the part before
    the first dot) is one of ``FORBIDDEN_MODULES``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in list(modules) if n.split(".", 1)[0] in FORBIDDEN_MODULES)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


class Window:
    """The measured window: open, then steps run while ``due()``.  Each
    step is recorded with its start, its end (after the host has read its
    loss, which waits for the device) and its samples or tokens; spans
    (``span(name)``) record host intervals by name, and, when the run is
    traced, the same interval as a profiler annotation."""

    def __init__(self, seconds: float, tracing: bool = False,
                 clock: Callable[[], float] = time.perf_counter):
        self.seconds = float(seconds)
        self.tracing = tracing
        self.clock = clock
        self.t0: Optional[float] = None
        self.steps: List[Tuple[float, float, int]] = []
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.losses: List[float] = []

    def open(self) -> float:
        self.t0 = self.clock()
        return self.t0

    def due(self) -> bool:
        return self.clock() - self.t0 < self.seconds

    def step(self, start: float, end: float, units: int, loss: float) -> None:
        self.steps.append((start, end, units))
        self.losses.append(loss)

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.tracing:
            from torch.profiler import record_function

            ctx = record_function(SPAN_PREFIX + name)
        start = self.clock()
        with ctx:
            yield
        self.spans.setdefault(name, []).append((start, self.clock()))

    # -- what the metric readers use ---------------------------------------

    @property
    def end(self) -> float:
        """The end of the window's last whole step."""
        if not self.steps:
            raise BenchmarkError("the window completed no step")
        return self.steps[-1][1]

    @property
    def elapsed(self) -> float:
        return self.end - self.t0

    @property
    def units(self) -> int:
        return sum(u for _, _, u in self.steps)

    def span_seconds(self, name: str) -> float:
        return sum(b - a for a, b in self.spans.get(name, ()))


class Run:
    """What the metric readers read: the window, the set-up time, the
    peak memory, the session's kind of work and frozen step counts, and
    the device trace (busy seconds, traced window) where there is one."""

    def __init__(self, window: Window, setup_s: float, peak_bytes: int, units: str,
                 step_counts: Dict[str, Any], peaks: Dict[str, float],
                 device: Optional[Dict[str, float]] = None):
        self.window = window
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.units = units
        self.step_counts = step_counts
        self.peaks = peaks
        self.device = device or {}


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    if not values:
        raise BenchmarkError("no values for a percentile")
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def warm_profiler(torch) -> None:
    """One throwaway profiler session on a small op: a process's first
    session can record no device activity, and it stalls the host while
    CUPTI starts."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(10):
            x = x * 1.0
        torch.cuda.synchronize()


def union_seconds(intervals: List[Tuple[float, float]], lo: float, hi: float
                  ) -> Tuple[float, List[Tuple[float, float]]]:
    """The length of the union of ``intervals`` clipped to [lo, hi], and
    the gaps between them (lo and hi included as edges), in the same units."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    busy, gaps, cur = 0.0, [], lo
    for a, b in clipped:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def read_trace(prof) -> Dict[str, Any]:
    """Busy seconds of the device within the traced window (the
    ``dsibench.window`` annotation), the window's length, the ten device
    operations that took most time and the ten longest idle gaps named by
    the innermost benchmark span open at the gap's start.  ``busy_s`` is
    None where the profiler recorded no device activity."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device_iv, by_name, host = [], {}, []
    win = None
    for ev in prof.events():
        a, b = ev.time_range.start, ev.time_range.end
        if ev.device_type == cuda and not ev.name.startswith(SPAN_PREFIX):
            device_iv.append((a, b))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (b - a)
        elif ev.name.startswith(SPAN_PREFIX):
            name = ev.name[len(SPAN_PREFIX):]
            if name == "window":
                win = (a, b)
            else:
                host.append((a, b, name))
    if win is None:
        raise BenchmarkError("the trace holds no dsibench.window annotation")
    lo, hi = win
    window_s = (hi - lo) / 1e6
    if not device_iv:
        return {"busy_s": None, "window_s": window_s, "device_ops": [], "idle_gaps": []}
    busy, gaps = union_seconds(device_iv, lo, hi)

    def at(t):
        inner = [(b - a, name) for a, b, name in host if a <= t < b]
        return min(inner)[1] if inner else "host"

    gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"busy_s": busy / 1e6, "window_s": window_s,
            "device_ops": [[name[:64], us / 1e6] for name, us in ops],
            "idle_gaps": [[at(a), (b - a) / 1e6] for a, b in gaps]}


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


def merged(base: Dict[str, Any], over: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: Optional[float] = None, root: Path = ROOT,
             overrides: Optional[Dict[str, Any]] = None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True),
             ) -> Tuple[Dict[str, Any], List[Tuple[str, float, float]]]:
    """One run of ``cell``: returns the result line's object and the
    numbers compared, each as (name, value, limit).  ``overrides`` merges
    into the configuration, traffic and limits (``{"config": ...,
    "traffic": ..., "limits": ...}``), for tests at a size the CPU holds."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    man = manifest(root)
    w = workload(man, cell)
    config = merged(load_json("configs", w["config"]), overrides.get("config"))
    traffic = merged(load_json("traffic", w["traffic"]), overrides.get("traffic"))
    limits = merged(load_json("cells", cell)["limits"], overrides.get("limits"))
    readers = {m["name"]: load_module("metrics", m["name"])
               for m in metrics_of(man, cell, trace)}
    runner = load_module("runners", config["runner"])
    reference = load_module("reference", config["reference"])
    peaks = load_json("peaks", "h100")

    cuda = torch.device(device).type == "cuda"
    session = runner.setup(config, traffic, seed, device, log)
    if trace and cuda:
        warm_profiler(torch)
    # set-up's live objects leave the collector's generations, so a
    # collection in the window scans only what the window makes
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()        # set-up's freed blocks go back before the window
        torch.cuda.reset_peak_memory_stats()
    window = Window(min(seconds, TRACE_SECONDS) if trace else seconds, tracing=trace)
    setup_s = time.perf_counter() - t_start
    log(f"[dsibench] {cell} seed {seed}: set-up {setup_s:.3f} s; window "
        f"{window.seconds} s{' traced' if trace else ''}; {threading.active_count()} threads")

    try:
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            with prof:
                with record_function(SPAN_PREFIX + "window"):
                    window.open()
                    session.run_window(window)
                    if cuda:
                        torch.cuda.synchronize()
        else:
            window.open()
            session.run_window(window)
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        durations = sorted(b - a for a, b, _ in window.steps)
        deciles = [durations[min(int(q * len(durations) / 10), len(durations) - 1)]
                   for q in range(11)]
        log(f"[dsibench] window: {len(window.steps)} steps, {window.units} {session.units} in "
            f"{window.elapsed:.6f} s (opened {window.seconds} s); step seconds by decile "
            f"{[round(d, 6) for d in deciles]}; the p95 is over {len(durations)} steps; "
            f"spans (s) {({k: round(window.span_seconds(k), 6) for k in window.spans})}")

        dev = None
        if prof is not None:
            dev = read_trace(prof) if cuda else None
            del prof
        run = Run(window, setup_s, peak, session.units, session.step_counts, peaks,
                  device={k: dev[k] for k in ("busy_s", "window_s")} if dev else None)
        metrics = {}
        for m in metrics_of(man, cell, trace):
            value = readers[m["name"]].read(run)
            if value is None:
                if not cuda:        # a CPU run has no device trace to read
                    continue
                raise BenchmarkError(f"metric {m['name']} found nothing to read in {cell}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    finally:
        gc.unfreeze()
        session.close_program()

    t = time.perf_counter()
    numbers = session.check(reference)
    log(f"[dsibench] the reference's check took {time.perf_counter() - t:.3f} s")
    checks = [(name, float(numbers[name]), float(limits[name])) for name in sorted(limits)]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    failed = sum(1 for x in window.losses if not math.isfinite(x))

    if cuda:
        props = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                 "count": w["chips"], "memory_peak_bytes": int(peak)}
    else:
        props = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if dev is not None:
        props["busy_s"] = dev["busy_s"]
        props["window_s"] = dev["window_s"]
    result = {"correct": bool(correct and failed == 0), "attempted": len(window.steps),
              "failed": failed, "metrics": metrics, "device": props}
    if dev is not None and dev["busy_s"] is not None:
        result["breakdown"] = {"device_ops": dev["device_ops"], "idle_gaps": dev["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result, checks
