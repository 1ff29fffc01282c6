"""Plain reference of the LM token path: the corpus's documents, in
partition order, each followed by an EOS token (0), as one stream cut
into rows of ``seq + 1`` tokens; ``rows`` consecutive rows make a batch,
whose tokens are a row's first ``seq`` and whose labels its last ``seq``."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

EOS = 0


def batches(docs: List[Tuple[np.ndarray, np.ndarray]], seq: int, rows: int
            ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Every whole batch of the corpus ``docs`` ((offsets, ids) a
    partition)."""
    parts = []
    for off, ids in docs:
        lengths = np.diff(off)
        stream = np.full(int(lengths.sum()) + len(lengths), EOS, np.int64)
        ends = np.cumsum(lengths + 1) - 1                 # each document's EOS
        keep = np.ones(len(stream), bool)
        keep[ends] = False
        stream[keep] = ids
        parts.append(stream)
    stream = np.concatenate(parts)
    n = len(stream) // (seq + 1) // rows * rows
    packed = stream[:n * (seq + 1)].reshape(n // rows, rows, seq + 1).astype(np.int32)
    return [(b[:, :-1], b[:, 1:]) for b in packed]
