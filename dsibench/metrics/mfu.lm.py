"""The LM step's share of the card's bf16 peak (%): the frozen model
FLOPs of the window's steps over the window's time x 989 TFLOP/s."""
MOVES = "lm_train_tokens_per_s"


def read(run):
    if run.units != "tokens" or not run.step_counts.get("flops"):
        return None
    flops = sum(run.step_counts["flops"])
    return 100.0 * flops / (run.window.elapsed * run.peaks["bf16_flops_per_s"])
