"""State carried across from the reference package.

The data path has no weights: its state is the warehouse.  A reference
``ColumnBatch`` handed over as numpy arrays becomes the port's
``ColumnBatch`` here, so the reference's generated partitions can be
written into a port ``Table`` and DWRF bytes compared across packages.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.schema import ColumnBatch, SparseColumn


def column_batch_from_numpy(
    num_rows: int,
    dense: Dict[int, np.ndarray],
    sparse: Dict[int, Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]],
    labels: Optional[np.ndarray] = None,
) -> ColumnBatch:
    """Build a port ``ColumnBatch`` from numpy columns: ``dense`` maps a
    feature id to its (num_rows,) values, ``sparse`` to its (offsets,
    values, scores or None).  Dict order is kept: it is the DWRF stream
    order."""
    for fid, col in dense.items():
        if len(col) != num_rows:
            raise ValueError(f"dense feature {fid}: {len(col)} rows != {num_rows}")
    out_sparse = {}
    for fid, (offsets, values, scores) in sparse.items():
        if len(offsets) != num_rows + 1:
            raise ValueError(
                f"sparse feature {fid}: {len(offsets)} offsets != {num_rows + 1}"
            )
        out_sparse[fid] = SparseColumn(offsets=offsets, values=values, scores=scores)
    if labels is not None and len(labels) != num_rows:
        raise ValueError(f"labels: {len(labels)} rows != {num_rows}")
    return ColumnBatch(num_rows=num_rows, dense=dict(dense), sparse=out_sparse,
                       labels=labels)
