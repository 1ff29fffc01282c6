"""Torch's intra-op threads in a test process: under pytest-xdist the
machine's cores are shared among the workers, one share each."""
import os

import torch


def share_cores() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()
