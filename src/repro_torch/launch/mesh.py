"""Device meshes over ``torch.distributed``.

A port of the reference's ``repro.launch.mesh``.  The reference's mesh is
a ``jax.sharding.Mesh`` over every device of the program; here each rank
is a process, and ``Mesh`` is its view of the mesh: the axis names, the
size of each axis (``shape``, a dict as in the reference), its own
coordinate on each axis, each axis's process group, and its device.  It
is built on ``torch.distributed.device_mesh.init_device_mesh``, with
ranks laid out row-major (rank = coordinates taken major to minor).

The default process group must be initialized first, with the backend
the caller chose (``distributed.spawn`` does both): ``nccl`` where each
rank has a card of its own, ``gloo`` on the CPU and where ranks share one
card.  Nothing here switches on what it finds.  The rank's device is
``device`` (``cuda``, the default, takes card ``rank % device_count``;
``resolve`` raises where there is none).

Collectives go through ``Mesh.all_reduce`` and ``Mesh.all_gather``.  A
collective over an axis of size 1 is skipped: there is nothing to
exchange.  Under gloo a CUDA tensor is staged through pinned host memory
for every collective, by design: gloo documents ``all_gather`` for CPU
tensors only, and one rule for every op keeps the result independent of
what a build's gloo accepts.

``VirtualMesh`` is the counterpart of the reference's dry run on 512
virtual host devices (``--xla_force_host_platform_device_count``): one
rank's view of a mesh of any shape, with no process group, whose
collectives return results of the right shape (``launch.dryrun`` runs a
step on it on the ``meta`` device).  Both meshes record each collective
they perform into the recorders ``record_collectives`` opens.

The reference's constants are a TPU v5e's; the port's are an H100 SXM's
(NVIDIA H100 Tensor Core GPU datasheet, SXM5 column), for the roofline
(``launch.roofline``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve

# H100 SXM (NVIDIA H100 Tensor Core GPU datasheet)
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                  # HBM3 bytes/s
NVLINK_BW = 450e9                 # NVLink 4 bytes/s each direction (900 GB/s both)
INTER_NODE_BW = 50e9              # one 400 Gb/s NDR InfiniBand port a GPU, bytes/s
GPUS_PER_NODE = 8                 # an HGX H100 8-GPU board


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a rank performed: its kind (``all-reduce`` or
    ``all-gather``), the bytes of its result, the mesh axis, the number
    of ranks in its group, and whether the group lies within one node of
    ``GPUS_PER_NODE`` ranks (ranks row-major over the axes)."""

    kind: str
    nbytes: int
    axis: str
    group: int
    node_local: bool


_RECORDERS: List[List[Collective]] = []


@contextlib.contextmanager
def record_collectives() -> Iterator[List[Collective]]:
    """A list that every collective either mesh performs in the block is
    appended to."""
    log: List[Collective] = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


def _record(kind: str, t: torch.Tensor, axis: str, shape: Dict[str, int],
            coord: Dict[str, int]) -> None:
    if not _RECORDERS:
        return
    names = list(shape)
    stride = math.prod(shape[a] for a in names[names.index(axis) + 1:])
    first = sum((0 if a == axis else coord[a]) * math.prod(shape[b] for b in names[i + 1:])
                for i, a in enumerate(names))
    last = first + (shape[axis] - 1) * stride
    c = Collective(kind, t.numel() * t.element_size(), axis, shape[axis],
                   first // GPUS_PER_NODE == last // GPUS_PER_NODE)
    for log in _RECORDERS:
        log.append(c)


class Mesh:
    """This rank's view of a device mesh."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...],
                 device: Union[str, torch.device] = "cuda"):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialized default process group "
                               "(distributed.spawn, or torch.distributed.init_process_group)")
        n = 1
        for s in shape:
            n *= s
        if n != dist.get_world_size():
            raise ValueError(f"mesh {dict(zip(axes, shape))} holds {n} ranks, the world "
                             f"{dist.get_world_size()}")
        dev = resolve(device, "Mesh")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        self.device = dev
        self.backend = dist.get_backend()
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        from torch.distributed.device_mesh import init_device_mesh

        self._mesh = init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))
        self._coord = {a: self._mesh.get_local_rank(a) for a in axes}

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self._coord[axis]

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis``."""
        return self._mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {dist.get_rank()} at {self._coord}, {self.device})"

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def all_reduce(self, t: torch.Tensor, axes: Union[str, Tuple[str, ...]]) -> torch.Tensor:
        """The sum of ``t`` over ``axes`` (one axis name or several), as a
        new tensor; ``t`` is kept."""
        out = t.clone()
        for a in ((axes,) if isinstance(axes, str) else axes):
            if self.shape[a] == 1:
                continue
            buf = self._host(out) if self._staged(out) else out
            dist.all_reduce(buf, group=self.group(a))
            if buf is not out:
                out.copy_(buf)
            _record("all-reduce", out, a, self.shape, self._coord)
        return out

    def all_gather(self, t: torch.Tensor, axes: Union[str, Tuple[str, ...]],
                   dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` over ``axes``, concatenated along ``dim`` in
        the order of their coordinates (several axes major to minor)."""
        for a in reversed((axes,) if isinstance(axes, str) else tuple(axes)):
            if self.shape[a] == 1:
                continue
            src = t.contiguous()
            if self._staged(src):
                src = self._host(src)
            parts = [torch.empty_like(src) for _ in range(self.shape[a])]
            dist.all_gather(parts, src, group=self.group(a))
            t = torch.cat(parts, dim=dim).to(t.device)
            _record("all-gather", t, a, self.shape, self._coord)
        return t

    def barrier(self) -> None:
        dist.barrier()


class VirtualMesh:
    """One rank's view of a mesh of ``shape`` over ``axes`` with no process
    group: the interface the steps use (``axis_names``, ``shape``,
    ``coord``, ``device``, ``all_reduce``, ``all_gather``, ``barrier``).
    The rank sits at ``coord`` (0 on every axis by default), on ``device``
    (``meta`` by default).  A collective returns a result of the right
    shape, the rank's own data standing for every rank's: ``all_reduce`` a
    clone, ``all_gather`` the pieces concatenated in coordinate order.
    Each is recorded as ``Mesh`` records it; an axis of size 1 is skipped,
    as ``Mesh`` skips it."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...],
                 coord: Optional[Tuple[int, ...]] = None,
                 device: Union[str, torch.device] = "meta"):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
        coord = tuple(coord) if coord is not None else (0,) * len(axes)
        if len(coord) != len(axes) or any(not 0 <= c < n for c, n in zip(coord, shape)):
            raise ValueError(f"coordinate {coord} is not on the mesh {shape}")
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self._coord = dict(zip(axes, coord))
        self.device = resolve(device, "VirtualMesh")

    def coord(self, axis: str) -> int:
        return self._coord[axis]

    def __repr__(self) -> str:
        return f"VirtualMesh({self.shape}, at {self._coord}, {self.device})"

    def all_reduce(self, t: torch.Tensor, axes: Union[str, Tuple[str, ...]]) -> torch.Tensor:
        out = t.clone()
        for a in ((axes,) if isinstance(axes, str) else axes):
            if self.shape[a] > 1:
                _record("all-reduce", out, a, self.shape, self._coord)
        return out

    def all_gather(self, t: torch.Tensor, axes: Union[str, Tuple[str, ...]],
                   dim: int = 0) -> torch.Tensor:
        for a in reversed((axes,) if isinstance(axes, str) else tuple(axes)):
            if self.shape[a] == 1:
                continue
            t = torch.cat([t.contiguous()] * self.shape[a], dim=dim)
            _record("all-gather", t, a, self.shape, self._coord)
        return t

    def barrier(self) -> None:
        pass


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: Union[str, torch.device] = "cuda") -> Mesh:
    """Elastic-scaling helper: a mesh of ``shape`` over the ranks of the
    default process group."""
    return Mesh(tuple(shape), tuple(axes), device)


def make_host_mesh(model_axis: Optional[int] = None,
                   device: Union[str, torch.device] = "cuda") -> Mesh:
    """(world // model_axis, model_axis) over ("data", "model")."""
    n = dist.get_world_size()
    m = model_axis or 1
    return Mesh((n // m, m), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "cuda") -> Mesh:
    """The reference's production meshes, (16, 16) over ("data", "model")
    or (2, 16, 16) over ("pod", "data", "model"); raises unless the world
    has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = shape[0] * shape[1] * (shape[2] if multi_pod else 1)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks, the world has {world}")
    return Mesh(shape, axes, device)
