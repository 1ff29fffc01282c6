"""CLI for the invariant gate.

  PYTHONPATH=src python -m repro_torch.analysis               # run the gate
  PYTHONPATH=src python -m repro_torch.analysis --list-rules  # rule catalog
  PYTHONPATH=src python -m repro_torch.analysis --write-baseline
  PYTHONPATH=src python -m repro_torch.analysis --json        # JSON lines

Exit status: 0 when every finding is baselined or suppressed, 1 when new
findings exist, 2 on usage errors.  ``scripts/ci_torch.sh`` runs this
after the port's tests.

``--json`` emits one JSON object per finding (``status`` is ``"new"`` or
``"baselined"``) instead of the human rendering — same exit codes — so
CI artifacts and ``bench_diff``-style tooling can consume the gate.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.core import (
    all_rules,
    load_baseline,
    run_checks,
    write_baseline,
)

DEFAULT_BASELINE = "scripts/analysis_baseline_torch.txt"


def _find_repo(start: Path) -> Path:
    """The repo root is wherever ``src/repro_torch`` lives: try cwd (how CI
    invokes us), then walk up from the installed package location."""
    if (start / "src" / "repro_torch").is_dir():
        return start
    here = Path(__file__).resolve()
    for p in here.parents:
        if (p / "src" / "repro_torch").is_dir():
            return p
    return start


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-native invariant linter over the PyTorch port "
                    "(lock discipline, clock injection, kernel parity, "
                    "metrics contract, thread hygiene)",
    )
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline file (default: <root>/{DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding as new")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings into the baseline and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON lines (machine-readable)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the per-known-finding lines")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, summary in all_rules().items():
            print(f"{rid}  {summary}")
        return 0

    repo = _find_repo(args.root or Path.cwd())
    if not (repo / "src" / "repro_torch").is_dir():
        print(f"repro_torch.analysis: no src/repro_torch under {repo}", file=sys.stderr)
        return 2
    baseline_path = args.baseline or (repo / DEFAULT_BASELINE)
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        new, known = run_checks(
            repo, rules=rules,
            baseline=None if args.no_baseline else load_baseline(baseline_path),
        )
    except ValueError as e:
        print(f"repro_torch.analysis: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        write_baseline(baseline_path, new + known)
        print(f"repro_torch.analysis: baselined {len(new) + len(known)} finding(s) "
              f"-> {baseline_path}")
        return 0

    if args.json:
        for status, batch in (("new", new), ("baselined", known)):
            for f in batch:
                print(json.dumps({
                    "rule": f.rule, "path": f.path, "line": f.line,
                    "symbol": f.symbol, "message": f.message,
                    "key": f.key, "status": status,
                }, sort_keys=True))
        return 1 if new else 0
    for f in new:
        print(f.render())
    if known and not args.quiet:
        for f in known:
            print(f"{f.render()}  (baselined)")
    n_rules = len(all_rules())
    if new:
        print(f"repro_torch.analysis: {len(new)} new finding(s) "
              f"({len(known)} baselined) across {n_rules} rules — FAIL")
        return 1
    print(f"repro_torch.analysis: ok — 0 new findings "
          f"({len(known)} baselined) across {n_rules} rules")
    return 0


if __name__ == "__main__":
    sys.exit(main())
