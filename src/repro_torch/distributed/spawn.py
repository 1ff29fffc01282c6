"""Start N ranks of one function, each in a process of its own.

``spawn(fn, nprocs, init_file, backend, args)`` starts ``nprocs``
processes with the ``spawn`` start method (which CUDA requires), each
joining one process group of ``backend`` through the ``file://``
rendezvous at ``init_file``, never a fixed TCP port, so that runs side by
side cannot collide.  Each rank calls ``fn(rank, *args)``; ``spawn``
returns the ranks' return values in rank order.  ``fn`` must be importable
by name (module level), and its arguments and return value picklable.

The ranks are joined with a timeout: a rank that fails raises here (the
others are stopped), and so does a run that outlasts ``timeout_s`` (every
rank is stopped).
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, List, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, nprocs: int, init_file: str, backend: str,
               args: Sequence[Any], out_dir: str, timeout_s: float) -> None:
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=nprocs,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    tmp = os.path.join(out_dir, f".rank{rank}")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}"))


def spawn(fn: Callable, nprocs: int, init_file: str, backend: str,
          args: Sequence[Any] = (), timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``nprocs`` ranks; their results in rank
    order.  ``init_file`` must not exist yet."""
    if os.path.exists(init_file):
        raise FileExistsError(f"rendezvous file {init_file} exists: give a fresh path")
    out_dir = tempfile.mkdtemp(prefix="ranks_", dir=os.path.dirname(init_file) or None)
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, init_file, backend, tuple(args), out_dir, timeout_s),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} "
                                   f"did not finish within {timeout_s} s")
        results = []
        for rank in range(nprocs):
            with open(os.path.join(out_dir, f"rank{rank}"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        if os.path.exists(init_file):
            os.remove(init_file)
