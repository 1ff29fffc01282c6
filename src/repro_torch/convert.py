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

An LM's weights in the reference are one tree whose layer leaves are
stacked on a leading layer axis: ``embed.{tok,out}``, ``layers.{ln1, ln2,
attn.{wq, wk, wv, wo, q_norm, k_norm}, ffn.{wi_gate, wi_up, wo}}`` and
``ln_f``; an SSM's layers hold ``ln1`` and ``mixer.{wz, wx, wB, wC, wdt,
conv_x, conv_B, conv_C, out}`` with the float32 ``mixer.{A_log, D,
dt_bias, norm}``.  The port's LMs hold one module per layer, so layer i's
leaf ``layers.attn.wq[i]`` is its parameter ``layers.{i}.attn.wq``.
bfloat16 leaves cross through their bits, so they come across exact.
The caches are stacked on the layer axis in both packages (``{"k", "v"}``
of the dense family, ``{"state", "conv_x", "conv_B", "conv_C"}`` of the
SSM), so they cross leaf by leaf.
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


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Dotted names -> a nested tree of numpy leaves (tensors converted)."""
    out: Dict[str, Any] = {}
    for name in sorted(flat):
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        v = flat[name]
        node[leaf] = _array(v) if isinstance(v, torch.Tensor) else v
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


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a CPU tensor of the same dtype; bfloat16 (numpy's
    ``ml_dtypes`` type) through its bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes           # numpy's bfloat16; installed beside the reference

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def lm_params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's LM parameter tree (numpy leaves, layers stacked on
    axis 0) -> the port's state dict (CPU tensors of the leaves' dtypes),
    for ``model.load_state_dict``."""
    out = {}
    for name, leaf in _flatten(tree).items():
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(leaf.shape[0]):
                out[f"layers.{i}.{rest}"] = _tensor(leaf[i])
        else:
            out[name] = _tensor(leaf)
    return out


def lm_params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """Inverse of ``lm_params_from_numpy``: the reference's nested tree of
    a port ``DecoderLM``, its layers stacked again."""
    flat: Dict[str, Any] = {}
    per_layer: Dict[str, Dict[int, np.ndarray]] = {}
    for name, p in model.state_dict().items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            per_layer.setdefault(rest, {})[int(i)] = _array(p)
        else:
            flat[name] = p
    for rest, leaves in per_layer.items():
        flat[f"layers.{rest}"] = np.stack([leaves[i] for i in sorted(leaves)])
    return _nest(flat)


def lm_cache_from_numpy(cache: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The reference's stacked cache (the KV cache ``{"k", "v"}`` of (L, B,
    S, KVH, D), or the SSM's state and conv tails) -> the port's, CPU
    tensors of the same dtypes."""
    return {name: _tensor(np.asarray(a)) for name, a in cache.items()}
