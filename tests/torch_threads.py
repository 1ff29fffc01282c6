"""Torch's intra-op threads in a test process: under pytest-xdist, the
machine's cores shared among the workers.

Each worker's torch starts one intra-op (OpenMP) thread a core by
default, so ``-n 6`` on a machine of 8 cores runs 48 of them at once.
They spin while they wait, and a small op then waits on every other
worker's: the port's test files, which run many small ops, ran several
times slower under the suite than alone.  Each ``tests/test_torch_*.py``
imports this module, which gives every worker ``cores // workers``
threads (at least 1).  Outside xdist torch keeps its default.  The
thread count changes no result a test holds: no test compares sums taken
in two thread counts.
"""
import os

import torch


def share_cores() -> int:
    """Set and return this process's intra-op thread count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


share_cores()
