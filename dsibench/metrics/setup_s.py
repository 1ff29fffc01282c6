"""Seconds from the run's start to the window's: imports, the traffic
and the weights made from the seed, the checked steps, the warm-up and,
on a checkout's first run, the kernels' build."""


def read(run):
    return run.setup_s
