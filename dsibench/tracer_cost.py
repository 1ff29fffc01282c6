"""The cost of the program's span ``Tracer`` on the card, with no profiler:
windows of one cell's session run in turns with ``NULL_TRACER`` and
with a fresh ``Tracer`` attached (the DLRM step's bundle, the LM
trainer), each of ``--seconds`` as a bench run's window.

    python3 -m dsibench.tracer_cost --workload <cell> --seed <n> \
        [--seconds 20] [--rounds 3]

One set-up as a bench run's, then ``--rounds`` rounds of two windows:
null first in rounds 0, 2, ... and traced first in rounds 1, 3, ....  Each window is
a JSON line on standard output (its steps, rate, median and p95 step
seconds); the last line holds each mode's median over its windows of the
windows' rates and median step seconds, and the traced mode's change in
% of the null mode's.  The reference's check is not run.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

ROOT = Path(__file__).resolve().parents[1]


def measure(cell: str, seed: int, seconds: float, rounds: int, device: str = "cuda",
            overrides: Optional[Dict[str, Any]] = None,
            log: Callable[[str], None] = lambda s: None,
            emit: Callable[[Dict[str, Any]], None] = lambda row: None) -> Dict[str, Any]:
    """The windows of ``cell`` in turns with and without a ``Tracer``
    (each passed to ``emit``) and the summary (module docstring);
    ``overrides`` as ``harness.run_cell``'s."""
    import torch

    from dsibench import harness
    from dsibench.span_trace import session_of
    from repro_torch.obs import NULL_TRACER, Tracer

    session, target = session_of(cell, seed, device, overrides, log)
    cuda = torch.device(device).type == "cuda"
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()        # set-up's freed blocks go back, as in a bench run
    rows = []
    try:
        for r in range(rounds):
            for mode in (("null", "tracer") if r % 2 == 0 else ("tracer", "null")):
                tracer = Tracer() if mode == "tracer" else NULL_TRACER
                target.attach_tracer(tracer)
                win = harness.Window(seconds)
                t = time.perf_counter()
                win.open()
                try:
                    session.run_window(win)
                finally:
                    target.attach_tracer(NULL_TRACER)
                if cuda:
                    torch.cuda.synchronize()
                steps = sorted(b - a for a, b, _ in win.steps)
                row = {"round": r, "mode": mode, "steps": len(steps),
                       "rate": win.units / win.elapsed,
                       "median_step_s": statistics.median(steps),
                       "p95_step_s": harness.p95(steps),
                       "spans": len(tracer.spans()),
                       "wall_s": time.perf_counter() - t}
                rows.append(row)
                emit(row)
    finally:
        gc.unfreeze()
        session.close_program()
    out: Dict[str, Any] = {"workload": cell, "seed": seed, "seconds": seconds,
                           "card": torch.cuda.get_device_name(0) if cuda else "cpu"}
    for mode in ("null", "tracer"):
        mine = [x for x in rows if x["mode"] == mode]
        out[mode] = {"rate": statistics.median(x["rate"] for x in mine),
                     "median_step_s": statistics.median(x["median_step_s"] for x in mine)}
    out["rate_change_pct"] = 100.0 * (out["tracer"]["rate"] / out["null"]["rate"] - 1.0)
    out["step_change_pct"] = 100.0 * (out["tracer"]["median_step_s"]
                                      / out["null"]["median_step_s"] - 1.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from dsibench.run import CACHE_DIRS

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "dsibench" / sub)
    os.environ["USE_FLAX"] = "0"
    out = measure(args.workload, args.seed, args.seconds, args.rounds,
                  log=lambda s: print(s, file=sys.stderr, flush=True),
                  emit=lambda row: print(json.dumps(row), flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
