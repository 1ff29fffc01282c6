"""Logical-axis sharding: map named tensor axes onto physical mesh axes.

A port of the reference's ``repro.distributed.sharding``.  The framework
annotates every parameter and activation with *logical* axis names
("embed", "heads", "mlp", "expert", ...).  A rule table maps logical
names to mesh axes ("pod", "data", "model").  One model definition then
serves DP / FSDP / TP / EP / SP layouts on both the single-pod (16, 16)
and multi-pod (2, 16, 16) meshes.

The rule tables, ``AxisRules``, ``logical_to_spec`` and ``spec_tree`` are
the reference's.  ``logical_to_spec`` reads only ``mesh.axis_names`` and
``mesh.shape[axis]``, so it runs unchanged on the port's
``launch.mesh.Mesh`` (or any object with those two attributes).  ``P`` is
the port's ``PartitionSpec``: a tuple of mesh axes, one per dimension,
trailing ``None``s dropped by ``logical_to_spec`` as in the reference.

``shard_tree`` is the torch meaning of the reference's: where the
reference places each leaf on the mesh with ``device_put``, here each
rank takes its own slice of each leaf along its spec.  The reference's
``named_sharding`` and ``with_logical`` have no torch meaning (there is
no ``NamedSharding`` and no sharding constraint for a compiler to keep):
they are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Union

MeshAxis = Union[str, Sequence[str], None]


class P(tuple):
    """The port's ``PartitionSpec``: one entry a dimension, each ``None``
    (replicated), a mesh axis name, or a tuple of mesh axis names."""

    def __new__(cls, *axes: MeshAxis) -> "P":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping of logical axis name -> mesh axis (or tuple of mesh axes)."""

    rules: Mapping[str, MeshAxis]

    def mesh_axes(self, logical: str, mesh: Optional[Any] = None) -> MeshAxis:
        ax = self.rules.get(logical)
        if ax is None:
            return None
        if mesh is not None:
            # Drop mesh axes that do not exist on this mesh (e.g. "pod" on a
            # single-pod mesh) so one rule table serves both meshes.
            names = set(mesh.axis_names)
            if isinstance(ax, str):
                return ax if ax in names else None
            kept = tuple(a for a in ax if a in names)
            if not kept:
                return None
            return kept[0] if len(kept) == 1 else kept

        return ax

    def replace(self, **updates: MeshAxis) -> "AxisRules":
        merged = dict(self.rules)
        merged.update(updates)
        return AxisRules(merged)


# Default rule tables.  "embed" is FSDP-sharded over the data axis during
# training (ZeRO-3 style in the reference); it is *replicated* for serving
# where latency matters more than memory.
TRAIN_RULES = AxisRules(
    {
        "batch": ("pod", "data"),
        "embed": "data",          # FSDP axis for parameters
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "expert": "model",
        "ssm_heads": "model",
        "seq": None,
        "seq_sp": "model",        # Megatron sequence parallelism: residual
                                  # stream sharded over model between matmuls
        "kv_seq": None,
        "expert_capacity": "data",
        "stack": None,            # scan-over-layers dim, never sharded
    }
)

# FSDP-heavy profile for small models on a big mesh: the model axis carries
# parameter shards + batch, not tensor-parallel compute.
FSDP_RULES = AxisRules(
    {
        "batch": ("pod", "data", "model"),
        "embed": ("data", "model"),
        "vocab": None,
        "heads": None,
        "kv_heads": None,
        "mlp": None,
        "expert": "model",
        "ssm_heads": None,
        "seq": None,
        "seq_sp": None,           # model axis already carries batch
        "kv_seq": None,
        "expert_capacity": "data",
        "stack": None,
    }
)

SERVE_RULES = AxisRules(
    {
        "batch": ("pod", "data"),
        "embed": None,            # replicate params over data for serving
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "expert": "model",
        "ssm_heads": "model",
        "seq": None,
        "seq_sp": "model",        # sequence parallelism for prefill
                                  # (no-op for decode: seq dim is 1)
        "kv_seq": "model",        # sequence-parallel KV cache for decode
        "expert_capacity": "data",
        "stack": None,
    }
)


def _axes(ax: MeshAxis) -> tuple:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _divisible(dim: int, ax: MeshAxis, mesh: Any) -> bool:
    if ax is None:
        return True
    n = 1
    for a in _axes(ax):
        n *= mesh.shape[a]
    return dim % n == 0


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: AxisRules,
    mesh: Any,
    shape: Optional[Sequence[int]] = None,
) -> P:
    """Build a PartitionSpec from per-dimension logical axis names.

    Any mesh axis may appear at most once in a PartitionSpec; later logical
    axes that would reuse an already-consumed mesh axis fall back to
    replication.  Dimensions not divisible by the mesh-axis size are also
    replicated (e.g. kv_heads=8 on a 16-way model axis).
    """
    used: set = set()
    out = []
    for i, name in enumerate(logical_axes):
        ax = rules.mesh_axes(name, mesh) if name else None
        if ax is None:
            out.append(None)
            continue
        axes = tuple(a for a in _axes(ax) if a not in used)
        # longest prefix of the requested mesh axes that divides the dim
        # (e.g. batch=(data,model) degrades to (data,) for small batches)
        while axes and shape is not None and not _divisible(shape[i], axes, mesh):
            axes = axes[:-1]
        if not axes:
            out.append(None)
            continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _is_logical(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def spec_tree(logical_tree: Any, rules: AxisRules, mesh: Any, shape_tree: Any = None) -> Any:
    """Map a tree (nested dicts) of logical-axes tuples to a tree of
    PartitionSpecs."""
    if _is_logical(logical_tree):
        return logical_to_spec(logical_tree, rules, mesh, shape_tree)
    return {k: spec_tree(v, rules, mesh, None if shape_tree is None else shape_tree[k])
            for k, v in logical_tree.items()}


def shard_index(spec_axes: MeshAxis, mesh: Any) -> tuple:
    """(shard count, this rank's shard) of a dimension split over
    ``spec_axes``: the axes' coordinates taken major to minor, as a
    ``NamedSharding`` lays its shards out."""
    n, k = 1, 0
    for a in _axes(spec_axes):
        n *= mesh.shape[a]
        k = k * mesh.shape[a] + mesh.coord(a)
    return n, k


def shard_leaf(x: Any, spec: P, mesh: Any) -> Any:
    """This rank's slice of ``x`` (a tensor or array) along ``spec``."""
    for dim, ax in enumerate(spec):
        n, k = shard_index(ax, mesh)
        if n == 1:
            continue
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
        step = size // n
        x = x[(slice(None),) * dim + (slice(k * step, (k + 1) * step),)]
    return x


def shard_tree(tree: Any, spec_tree_: Any, mesh: Any) -> Any:
    """This rank's slice of each leaf of ``tree`` along its spec in
    ``spec_tree_`` (nested dicts of the same keys)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, spec_tree_[k], mesh) for k, v in tree.items()}
    return shard_leaf(tree, spec_tree_, mesh)
