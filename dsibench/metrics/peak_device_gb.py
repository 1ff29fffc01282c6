"""The card's peak allocated memory over the window (the allocator's
``max_memory_allocated`` after a reset at the window's start), in 10^9
bytes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
