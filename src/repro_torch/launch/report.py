"""Render the roofline table from a dry run's JSONL.

A plain copy of the reference's ``repro.launch.report``: it renders the
records of either package's dry run (``results/dryrun.jsonl`` or
``results/dryrun_torch.jsonl``) to the same table.

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun_torch.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List


def load(path: str) -> List[dict]:
    rows = []
    seen = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = (r.get("arch"), r.get("shape"), r.get("multi_pod"))
            seen[key] = r  # last write wins (resumed sweeps)
    return list(seen.values())


def fmt_row(r: dict) -> str:
    if r["status"] == "skipped":
        return (
            f"| {r['arch']} | {r['shape']} | {'2x16x16' if r['multi_pod'] else '16x16'} "
            f"| skipped | — | — | — | — | — | {r['reason'][:58]} |"
        )
    if r["status"] != "ok":
        return f"| {r['arch']} | {r['shape']} | — | ERROR | — | — | — | — | — | {r.get('error','')[:58]} |"
    rf = r["roofline"]
    ratio = rf.get("useful_flops_ratio")
    frac = rf.get("roofline_fraction")
    return (
        f"| {r['arch']} | {r['shape']} | {r['mesh']} | {rf['bottleneck']} "
        f"| {rf['compute_s']:.3g} | {rf['memory_s']:.3g} | {rf['collective_s']:.3g} "
        f"| {ratio:.2f} | {frac*100 if frac else 0:.1f}% "
        f"| mem/dev={r['memory_analysis'].get('total_bytes_per_device', 0)/1e9:.1f}GB |"
    )


HEADER = (
    "| arch | shape | mesh | bottleneck | compute_s | memory_s | collective_s "
    "| 6ND/HLO | roofline-frac | notes |\n"
    "|---|---|---|---|---|---|---|---|---|---|"
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--single-pod-only", action="store_true")
    args = ap.parse_args()
    rows = load(args.path)
    rows.sort(key=lambda r: (r.get("arch", ""), r.get("shape", ""), r.get("multi_pod", False)))
    print(HEADER)
    for r in rows:
        if args.single_pod_only and r.get("multi_pod"):
            continue
        print(fmt_row(r))
    ok = [r for r in rows if r["status"] == "ok" and not r.get("multi_pod")]
    if ok:
        worst = min(ok, key=lambda r: r["roofline"].get("roofline_fraction") or 1.0)
        coll = max(ok, key=lambda r: r["roofline"]["collective_s"] / max(r["roofline"]["step_time_s"], 1e-9))
        print(f"\n# worst roofline fraction: {worst['arch']}/{worst['shape']} "
              f"({(worst['roofline']['roofline_fraction'] or 0)*100:.1f}%)")
        print(f"# most collective-bound: {coll['arch']}/{coll['shape']} "
              f"(collective_s={coll['roofline']['collective_s']:.3g} of step {coll['roofline']['step_time_s']:.3g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
