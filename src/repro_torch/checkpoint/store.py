"""Sharded, atomic checkpointing for train state (fault tolerance).

Layout: ``<dir>/step_<n>/shard_<k>.msgpack`` + ``manifest.json``.  Each
process writes only the leaves it owns, so on a multi-host run every
host persists its slice; on one host there is one shard.  Writes are
staged to a temp dir and renamed for atomicity; ``latest_step`` skips
incomplete checkpoints, so a crash mid-save falls back to the previous
complete one.

A port of the reference's ``repro.checkpoint.store`` that writes the
same bytes: a shard is one msgpack map (``wire``) from each leaf's path
to ``{"dtype", "shape", "data"}``.  A path is the reference's
``jax.tree_util.keystr`` of the leaf, ``['params']['bottom']['w0']``,
built here from the nested dicts, and the leaves come in sorted-key
order, the order ``tree_flatten_with_path`` gives a dict.  ``dtype`` is
numpy's ``dtype.str`` (``'<f4'``) or ``"bfloat16"``, whose 2-byte bits
cross through ``int16``.  A tree is nested dicts of torch tensors (moved
to the host to be written) or numpy arrays; ``load_pytree`` returns CPU
tensors, so each package reads the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import wire


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _encode_leaf(leaf: Any) -> Dict[str, Any]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            dtype, a = "bfloat16", t.view(torch.int16).numpy()
        else:
            a = t.numpy()
            dtype = a.dtype.str
    else:
        a = np.ascontiguousarray(leaf)
        dtype = "bfloat16" if a.dtype.name == "bfloat16" else a.dtype.str
    return {"dtype": dtype, "shape": list(a.shape),
            "data": memoryview(a.reshape(-1).view(np.uint8))}


def _decode_leaf(d: Dict[str, Any]) -> torch.Tensor:
    shape = tuple(d["shape"])
    if d["dtype"] == "bfloat16":
        a = np.frombuffer(d["data"], np.int16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(shape).copy())


def _unflatten(template: Any, payload: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, payload, f"{prefix}[{k!r}]") for k, v in template.items()}
    out = _decode_leaf(payload[prefix])
    want = tuple(template.shape) if hasattr(template, "shape") else np.shape(template)
    if tuple(out.shape) != want:
        raise ValueError(f"checkpoint leaf {prefix} has shape {tuple(out.shape)}, "
                         f"the template {want}")
    return out


def save_pytree(tree: Any, path: str, shard: int = 0) -> None:
    os.makedirs(path, exist_ok=True)
    payload = {k: _encode_leaf(v) for k, v in _flatten_with_paths(tree)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        wire.pack(payload, f)
    os.replace(tmp, os.path.join(path, f"shard_{shard}.msgpack"))


def load_pytree(template: Any, path: str, shard: int = 0) -> Any:
    """The leaves of ``template``'s paths read from the shard, as CPU
    tensors in ``template``'s structure; a path the shard lacks raises
    ``KeyError``."""
    with open(os.path.join(path, f"shard_{shard}.msgpack"), "rb") as f:
        buf = f.read()
    return _unflatten(template, wire.unpackb(buf))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, state: Dict[str, Any]) -> None:
        final = self._step_dir(step)
        stage = tempfile.mkdtemp(dir=self.directory, prefix=".staging_")
        try:
            save_pytree(state, stage)
            with open(os.path.join(stage, "manifest.json"), "w") as f:
                json.dump({"step": step, "complete": True}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(stage, final)
        except Exception:
            shutil.rmtree(stage, ignore_errors=True)
            raise
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.directory)):
            if not name.startswith("step_"):
                continue
            manifest = os.path.join(self.directory, name, "manifest.json")
            if os.path.exists(manifest):
                try:
                    with open(manifest) as f:
                        if json.load(f).get("complete"):
                            out.append(int(name.split("_")[1]))
                except (json.JSONDecodeError, ValueError):
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Dict[str, Any], step: Optional[int] = None) -> Tuple[int, Any]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.directory}")
        return step, load_pytree(template, self._step_dir(step))
