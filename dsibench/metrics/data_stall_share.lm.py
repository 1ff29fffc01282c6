"""The share of the window (%) in which ``Trainer.fit`` waited for its
next batch: reading the DWRF corpus, the decode kernels and packing."""
MOVES = "lm_train_tokens_per_s"


def read(run):
    if run.units != "tokens" or "stall" not in run.window.spans:
        return None
    return 100.0 * run.window.span_seconds("stall") / run.window.elapsed
