"""The 95th percentile, over every step of the window, of a DLRM step's
time from the hand-off of its host batch to its loss read on the host."""
from dsibench.harness import p95


def read(run):
    if run.units != "samples":
        return None
    return 1e3 * p95([b - a for a, b, _ in run.window.steps])
