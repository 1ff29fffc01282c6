"""Repo-native static analysis + runtime sanitizers over the PyTorch port
(``repro_torch.analysis``).

The same gate, rule ids and sanitizers as the JAX package's
``repro.analysis``, pointed at ``src/repro_torch``.  The DSI pipeline is
only trustworthy at scale because its invariants hold under heavy
concurrency; on the card the port's DPP worker threads also launch CUDA
kernels.  The static rules:

  * **lock discipline** (``REPRO-L001/L002/L003``): classes that declare a
    ``self._lock`` must not mutate shared attributes in public methods
    outside a ``with self._lock`` block; helpers that assume the lock is
    held carry a ``_locked`` suffix and are only called under the lock.
  * **clock injection** (``REPRO-C001``): ``core/dpp`` and ``core/cache``
    read absolute time only through an injected ``clock=`` callable.
  * **kernel parity** (``REPRO-K001/K002``): every ``OP_*`` code of the
    CUDA kernel ``csrc/fused_transform.cu`` has a counterpart in the plain
    versions ``kernels/ref.py`` and is exercised by
    ``tests/test_torch_engines.py``; every public kernel of
    ``kernels/ops.py`` and ``kernels/decode.py`` is named by one of the
    port's CPU differential suites.
  * **metrics contract** (``REPRO-M001/M002``): benchmark-read metric
    fields must exist on the metric dataclasses, and counters are
    monotonic (no ``-=``).
  * **thread hygiene** (``REPRO-T001/T002``): every ``threading.Thread``
    is daemonized or joined; bare ``except:`` is banned.
  * **race publication** (``REPRO-R001/R002``): lock-free fields of the
    race-instrumented classes are declared in ``_unshared``; no
    double-checked locking.

Run the gate with ``python -m repro_torch.analysis`` (wired into
``scripts/ci_torch.sh``).  Findings are suppressible inline with
``# repro: noqa(RULE-ID)`` or via the checked-in baseline
(``scripts/analysis_baseline_torch.txt``), so the gate is additive: it
fails only on NEW findings.

The runtime side: :mod:`repro_torch.analysis.lockdep` (lock-order
cycles), :mod:`repro_torch.analysis.racedep` (lockset races on the
port's threaded classes) and :mod:`repro_torch.analysis.sched` (every
bounded interleaving of the control-plane scenarios, on a ``device``).

Dependency-free by design: stdlib ``ast`` + ``threading`` only; it
imports neither torch nor the JAX package (``core_classes()`` and the
scenarios import the port's classes when called).
"""
from repro_torch.analysis.core import (
    Finding,
    all_rules,
    load_baseline,
    run_checks,
    write_baseline,
)

__all__ = [
    "Finding",
    "all_rules",
    "load_baseline",
    "run_checks",
    "write_baseline",
]
