"""LM training throughput: the tokens of every step the window completed
over the time from the window's start to the end of its last step (the
host has read that step's loss, which waits for the card)."""


def read(run):
    if run.units != "tokens":
        return None
    return run.window.units / run.window.elapsed
