"""Cost analysis of a step from its op trace.

A port of the reference's ``repro.launch.hlo_analysis``.  There, "HLO" is
the compiled program's text, walked with each while loop's trip count;
here it is the op trace a step leaves under a ``TorchDispatchMode``:
``trace(fn, *args, **kwargs)`` runs ``fn`` once, eagerly, and records

* every aten op, with its operands' and results' shapes and dtypes and
  its site: the innermost function of the port on the Python stack
  (``models.attention.blocked_attention``), and in a backward the
  autograd node that ran it (``< MmBackward0``);
* every kernel op of ``kernels/ops.py``, with its work from
  ``launch.roofline.kernel_work``.  The aten ops of a plain version that
  runs inside a kernel op (on the CPU) are not counted again, so a kernel
  costs the same on ``cpu``, ``cuda`` and ``meta``;
* the mesh's collectives (``launch.mesh.record_collectives``);
* the bytes of the storages alive during the step above its arguments:
  each storage an op (or a kernel op) makes is counted from the op that
  makes it until it is freed, and the peak is kept (``memory``).

``analyze(trace)`` returns the reference's ``HloCost``:

* ``flops``: the dot family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``mv``, ``dot``, ``convolution``) at 2 x result x K, plus the kernels'
  operations;
* ``bytes_accessed``: each op's operands read and its results written.
  Eager ops are not fused, so this is the port's own traffic; view and
  alias ops and ``empty`` are free, as ``_FREE_OPCODES`` are in the
  reference, and a collective's bytes are its own (``wire_bytes``);
* ``wire_bytes``, ``collective_counts`` (ring model, ``roofline``) and
  ``dot_flops_by_meta`` (by site);
* ``unknown_trip_loops``: always 0.  Eager mode runs every layer and every
  loop trip, so there is no trip count to miss.

There is no ``bf16_activations`` correction: the traced tensors keep
their own dtypes, where XLA's CPU backend promoted bf16 to float32.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline as rl

_DOT_OPS = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot", "convolution"}
_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))      # .../repro_torch
_SKIP_FILES = {os.path.abspath(__file__), os.path.abspath(kernel_ops.__file__)}


@dataclasses.dataclass
class OpRecord:
    """One op of a trace: ``op`` is the aten overload (``aten.mm.default``)
    or ``kernel.<name>`` for a kernel op."""

    op: str
    site: str
    inputs: Tuple[Tuple[str, Tuple[int, ...]], ...]
    outputs: Tuple[Tuple[str, Tuple[int, ...]], ...]
    flops: float
    bytes: float


@dataclasses.dataclass
class Trace:
    """What ``trace`` saw: the ops in order, the collectives, the result,
    and the memory of the step (bytes: ``argument``, ``output``, ``alias``
    (outputs whose storage is an argument's) and ``peak_live`` (the most
    bytes of storages the step made alive at once))."""

    ops: List[OpRecord]
    collectives: List[meshlib.Collective]
    memory: Dict[str, int]
    result: Any = None

    def kernel_calls(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.ops:
            if r.op.startswith("kernel."):
                out[r.op[7:]] = out.get(r.op[7:], 0) + 1
        return out

    def op_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.ops:
            out[r.op] = out.get(r.op, 0) + 1
        return out


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _sig(ts: List[torch.Tensor]) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    return tuple((str(t.dtype)[6:], tuple(t.shape)) for t in ts)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args: Tuple[Any, ...], outs: List[torch.Tensor]) -> float:
    if not outs:
        return 0.0
    result = outs[0].numel()
    if name in ("mm", "bmm", "mv", "dot"):
        k = args[0].shape[-1]
    elif name in ("addmm", "baddbmm"):
        k = args[1].shape[-1]
    else:                                         # convolution: (input, weight, ...)
        w = args[1]
        k = w.shape[1] * math.prod(w.shape[2:])
    return 2.0 * result * k


def _free_op(func) -> bool:
    """A view or alias op (a result that aliases an input and is not
    written), or an ``empty``: no bytes move."""
    name = func.overloadpacket.__name__
    if name.startswith("empty") or name in ("detach", "lift_fresh", "alias"):
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


class _Tracer(TorchDispatchMode):
    def __init__(self, arg_tensors: List[torch.Tensor]):
        super().__init__()
        self.ops: List[OpRecord] = []
        self._sites: Dict[Any, Optional[str]] = {}
        self._kernel_depth = 0
        self._live: Dict[int, int] = {}
        self._args = {id(t.untyped_storage()) for t in arg_tensors}
        self.argument_bytes = sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                                   for t in arg_tensors}.values())
        self.live = 0
        self.peak = 0
        self.active = True

    # -- sites --------------------------------------------------------------
    def _label(self, code) -> Optional[str]:
        label = self._sites.get(code, False)
        if label is not False:
            return label
        path = os.path.abspath(code.co_filename)
        label = None
        if path.startswith(_PORT + os.sep) and path not in _SKIP_FILES:
            mod = os.path.relpath(path, _PORT)[:-3].replace(os.sep, ".")
            label = f"{mod}.{code.co_name}"
        self._sites[code] = label
        return label

    def _site(self) -> str:
        f = sys._getframe(2)
        label = None
        while f is not None:
            label = self._label(f.f_code)
            if label is not None:
                break
            f = f.f_back
        node = torch._C._current_autograd_node()
        label = label or "?"
        return f"{label} < {node.name()}" if node is not None else label

    # -- memory -------------------------------------------------------------
    def _made(self, outs: List[torch.Tensor]) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live or key in self._args:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live += n
            weakref.finalize(st, self._freed, key)
        self.peak = max(self.peak, self.live)

    def _freed(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    # -- ops ----------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._kernel_depth or not self.active:
            return out
        outs = _tensors(out)
        self._made(outs)
        if func.namespace != "aten":              # c10d: counted as collectives
            return out
        ins = _tensors((args, kwargs))
        name = func.overloadpacket.__name__
        flops = _dot_flops(name, args, outs) if name in _DOT_OPS else 0.0
        nbytes = 0 if _free_op(func) else (sum(_nbytes(t) for t in ins)
                                            + sum(_nbytes(t) for t in outs))
        self.ops.append(OpRecord(str(func), self._site(), _sig(ins), _sig(outs), flops, nbytes))
        return out

    def kernel_call(self, name: str, fn: Callable, args, kwargs):
        """A kernel op (``kernels/ops.py``): its work counted once, none of
        the ops inside it."""
        if self._kernel_depth or not self.active:
            return fn(*args, **kwargs)
        site = self._site()
        self._kernel_depth += 1
        try:
            ops_, nbytes = rl.kernel_work(name, *args, **kwargs)
            out = fn(*args, **kwargs)
        finally:
            self._kernel_depth -= 1
        outs = _tensors(out)
        self._made(outs)
        self.ops.append(OpRecord(f"kernel.{name}", site, _sig(_tensors((args, kwargs))),
                                 _sig(outs), float(ops_), float(nbytes)))
        return out


def trace(fn: Callable, *args, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` once under the analyzer (module
    docstring) and return what it saw, with ``fn``'s result."""
    arg_tensors = _tensors((args, kwargs))
    tracer = _Tracer(arg_tensors)
    kernel_ops.TRACERS.append(tracer)
    try:
        with meshlib.record_collectives() as log, tracer:
            result = fn(*args, **kwargs)
    finally:
        kernel_ops.TRACERS.remove(tracer)
        tracer.active = False
    out_st = {id(t.untyped_storage()): t.untyped_storage().nbytes() for t in _tensors(result)}
    memory = {
        "argument": tracer.argument_bytes,
        "output": sum(out_st.values()),
        "alias": sum(n for k, n in out_st.items() if k in tracer._args),
        "peak_live": tracer.peak,
    }
    return Trace(ops=tracer.ops, collectives=list(log), memory=memory, result=result)


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    wire_bytes: float = 0.0            # per-device collective bytes (ring model)
    collective_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    dot_flops_by_meta: Dict[str, float] = dataclasses.field(default_factory=dict)
    unknown_trip_loops: int = 0
    # the part of wire_bytes whose group spans nodes (the inter-node rate)
    inter_node_wire_bytes: float = 0.0


def analyze(tr: Trace) -> HloCost:
    """The cost of a traced step (module docstring)."""
    cost = HloCost()
    for r in tr.ops:
        cost.flops += r.flops
        cost.bytes_accessed += r.bytes
        if r.flops and not r.op.startswith("kernel."):
            cost.dot_flops_by_meta[r.site] = cost.dot_flops_by_meta.get(r.site, 0) + r.flops
    stats = rl.parse_collectives(tr.collectives)
    cost.wire_bytes = stats.wire_bytes_per_device
    cost.inter_node_wire_bytes = stats.inter_node_wire_bytes
    cost.collective_counts = dict(stats.counts)
    return cost


def memory_analysis(tr: Trace) -> Dict[str, int]:
    """The reference's ``memory_analysis`` record from a trace: arguments,
    outputs, temporaries (the peak of the storages the step made, less
    the new outputs it ends with) and aliases (outputs that are arguments
    updated in place); ``total_bytes_per_device`` = arguments + outputs
    + temporaries - aliases, the reference's sum."""
    m = tr.memory
    new_out = m["output"] - m["alias"]
    temp = max(0, m["peak_live"] - new_out)
    return {
        "argument_bytes": m["argument"],
        "output_bytes": m["output"],
        "temp_bytes": temp,
        "alias_bytes": m["alias"],
        "total_bytes_per_device": m["argument"] + m["output"] + temp - m["alias"],
    }
