"""The DLRM step's share of its roofline (%): the least time of the
window's steps (each the larger of its frozen bytes over the memory
bandwidth and its frozen FLOPs over the float32 peak, ``counts``) over
the window's time."""
from dsibench.counts import least_seconds

MOVES = "dlrm_train_samples_per_s"


def read(run):
    c = run.step_counts
    if run.units != "samples" or not c.get("bytes"):
        return None
    least = sum(least_seconds(f, b, run.peaks["fp32_flops_per_s"], run.peaks["hbm_bytes_per_s"])
                for f, b in zip(c["flops"], c["bytes"]))
    return 100.0 * least / run.window.elapsed
