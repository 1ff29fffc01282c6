#!/usr/bin/env bash
# The PyTorch port's gate, on the CPU: its tests, its invariant gate and its
# concurrency sanitizers, one command (scripts/ci.sh stays the reference's).
#   ./scripts/ci_torch.sh [extra pytest args...]
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
# the port's differential tests against the reference (card-only tests
# skip); the sanitizer tests run on their own after the gate
tests=()
for f in tests/test_torch_*.py; do
  [[ $f == tests/test_torch_sanitizers.py ]] || tests+=("$f")
done
python -m pytest -q "${tests[@]}" "$@"
# invariant gate over src/repro_torch: lock discipline, clock injection,
# kernel parity against csrc/fused_transform.cu, metrics contract, span and
# thread hygiene, race publication; empty baseline
python -m repro_torch.analysis
# concurrency sanitizers: the detectors' verdicts against the reference's,
# a raced DPP session and cache traffic, the explorer's counts
python -m pytest -q tests/test_torch_sanitizers.py
# every control-plane scenario under all bounded schedules, on the CPU
python -m repro_torch.analysis.sched --device cpu -q
