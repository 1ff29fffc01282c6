"""Run one cell of the benchmark once, on the card this process sees.

    python3 -m dsibench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON object; the last lines of standard error are the numbers
compared for ``correct``, each beside its limit.  Without a CUDA card, or
with fewer cards than the cell asks for, it exits with 2 and prints no
result; with JAX or the JAX package loaded once the window has closed,
with 3, naming what it found; any other failure exits nonzero with no
result either.  Every build and kernel cache goes under ``build/`` in
the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "dsibench" / sub)
    os.environ["USE_FLAX"] = "0"
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"dsibench: no src/repro_torch under {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from dsibench import harness

    man = harness.manifest(ROOT)
    chips = harness.workload(man, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"dsibench: {args.workload} needs {chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), device="cuda", t_start=T_START)
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"dsibench: loaded in this process once the window closed: {forbidden}",
              file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
