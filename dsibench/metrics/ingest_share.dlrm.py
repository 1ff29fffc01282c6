"""The share of the window (%) spent handing host batches to the card
(``StepBundle.shard_batch``: ids, mask, dense features and labels copied
from pageable host memory)."""
MOVES = "dlrm_train_samples_per_s"


def read(run):
    if run.units != "samples" or "handoff" not in run.window.spans:
        return None
    return 100.0 * run.window.span_seconds("handoff") / run.window.elapsed
