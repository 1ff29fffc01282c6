"""The DLRM step's share of the card's float32 peak (%): the frozen
model FLOPs of the window's steps over the window's time x 67 TFLOP/s
(the configuration computes in float32)."""
MOVES = "dlrm_train_samples_per_s"


def read(run):
    if run.units != "samples" or not run.step_counts.get("flops"):
        return None
    flops = sum(run.step_counts["flops"])
    return 100.0 * flops / (run.window.elapsed * run.peaks["fp32_flops_per_s"])
