"""Debug tool: attribute the analyzer's bytes, wire bytes and flops to
sites.

A port of the reference's ``repro.launch.debug_hlo``.  There a site is an
HLO op's opcode and the tail of its ``op_name``; here "HLO" is the op
trace of ``launch.hlo_analysis.trace``, and a site is the op's module
path (the innermost function of the port that ran it, with the autograd
node in a backward) and the op.  A collective's site is its kind, axis,
group size and result bytes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.debug_hlo --arch qwen3-8b \\
      --shape train_4k [--smoke] [--mesh 16x16] [--top 15]
or programmatically via ``attribute(trace)`` and ``report(trace)``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Tuple

from repro_torch.launch.hlo_analysis import Trace
from repro_torch.launch.roofline import _collective_wire


def attribute(tr: Trace) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, float]]:
    """(bytes, wire bytes, flops) by site; each sums to ``analyze``'s total."""
    bytes_by_site: Dict[str, float] = {}
    wire_by_site: Dict[str, float] = {}
    flops_by_site: Dict[str, float] = {}
    for r in tr.ops:
        op = r.op[7:] if r.op.startswith("kernel.") else r.op.split(".")[1]
        key = f"{op}:{r.site}"
        if r.bytes:
            out = r.outputs[0] if r.outputs else ("", ())
            k = f"{key} {out[0]}{list(out[1])}"[:200]
            bytes_by_site[k] = bytes_by_site.get(k, 0) + r.bytes
        if r.flops:
            flops_by_site[key] = flops_by_site.get(key, 0) + r.flops
    for c in tr.collectives:
        key = f"{c.kind}:{c.axis} g={c.group} {c.nbytes}B"
        wire_by_site[key] = wire_by_site.get(key, 0) + _collective_wire(c.kind, c.nbytes, c.group)
    return bytes_by_site, wire_by_site, flops_by_site


def report(tr: Trace, top: int = 15) -> None:
    b, w, f = attribute(tr)
    for title, d in (("BYTES", b), ("WIRE", w), ("FLOPS", f)):
        tot = sum(d.values()) or 1.0
        print(f"== {title} total {tot:.4e}")
        for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]:
            print(f"  {v:.3e} {v / tot * 100:5.1f}%  {k[:130]}")


def main() -> int:
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 2x2 (default: the production mesh)")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    mesh = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None
    report(dryrun.trace_cell(args.arch, args.shape, mesh_shape=mesh, smoke=args.smoke)[0],
           args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
