"""State carried across from the reference package.

The data path has no weights: its state is the warehouse.  A reference
``ColumnBatch`` handed over as numpy arrays becomes the port's
``ColumnBatch`` here, so the reference's generated partitions can be
written into a port ``Table`` and DWRF bytes compared across packages.

The trainer's state is the DLRM's weights and the AdamW state.  The
reference holds them as nested dicts, ``{"bottom": {"w0", "b0", ...},
"top": {...}, ["tables"]}``, each MLP weight ``w{i}`` of shape (din,
dout) applied as ``x @ w + b``.  The port keeps that layout (its MLP
layers are not ``nn.Linear``), so nothing is transposed: a nested key
becomes the port's parameter name ``"bottom.w0"``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nest(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name in sorted(flat):
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[name].detach().cpu().numpy()
    return out


def dlrm_params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's DLRM parameter tree (numpy leaves) -> the port's
    parameters by name (``DLRM.params()`` keys), float32 CPU tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in _flatten(tree).items()}


def dlrm_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``dlrm_params_from_numpy``: the reference's nested tree."""
    return _nest(params)


def adamw_state_from_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's AdamW state ``{"mu", "nu", "step"}`` (numpy leaves)
    -> the port's: ``mu``/``nu`` by parameter name, ``step`` an int32
    scalar tensor."""
    return {
        "mu": dlrm_params_from_numpy(state["mu"]),
        "nu": dlrm_params_from_numpy(state["nu"]),
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32),
    }


def adamw_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``adamw_state_from_numpy``."""
    return {
        "mu": _nest(state["mu"]),
        "nu": _nest(state["nu"]),
        "step": np.asarray(int(state["step"]), np.int32),
    }
