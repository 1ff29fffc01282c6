"""The card's idle share (%) over the traced window: 1 - the union of
the device operations' intervals in the profiler's trace over the
window's length."""
MOVES = "lm_train_tokens_per_s"


def read(run):
    busy, window = run.device.get("busy_s"), run.device.get("window_s")
    if run.units != "tokens" or busy is None or not window:
        return None
    return 100.0 * (1.0 - busy / window)
