"""Pluggable TransformEngine: fused CUDA execution of the transform DAG.

The paper's §7.2 flagship observation is that launching one kernel over a
tensor combining ~1000 sparse features is ~3 orders of magnitude faster
than per-feature dispatch, and §6.3 shows transform dominating DPP worker
cycles.  Mirrors the reference's ``repro.core.engine``:

  * ``NumpyEngine`` — the reference engine: executes the per-feature DAG
    exactly like ``TransformPipeline.__call__`` (one vectorized numpy call
    per spec), while accounting per-op "kernel launches".
  * ``TorchEngine`` — the counterpart of the reference's ``PallasEngine``:
    compiles the DAG into **waves** of fusable ops (SigridHash,
    PositiveModulus, Clamp, Bucketize), packs each wave features-major
    into the op-code/param layout of ``repro_torch.kernels.fused_transform``
    and executes the whole wave in ONE launch on the engine's device
    (the CUDA kernel on ``cuda``, its plain PyTorch version on ``cpu``).
    Ops the kernel cannot express (NGram, Cartesian, MapId, FirstX, ...)
    fall back per-feature to the numpy implementations.

Both engines produce **byte-identical** environments (and therefore
byte-identical minibatches): the SigridHash mixer is the shared 32-bit
two-round multiply-xor-shift (``transforms._mix32`` == kernel
``hash_u32``), bucketize compares in float32 on both paths, and any op
whose inputs would break bit-parity (ids outside int32 for
PositiveModulus, non-float32 dense columns, ...) is *demoted* to the
numpy fallback at run time.

``EngineStats`` feeds ``WorkerMetrics`` (fused vs fallback feature counts,
kernel launches, per-path transform seconds) so Table-9-style breakdowns
can compare engines.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.schema import ColumnBatch, SparseColumn
from repro_torch.core.transforms import (
    _OPS,
    Column,
    TransformPipeline,
    TransformSpec,
)
from repro_torch.kernels import ops as kops
from repro_torch.obs import counter

# Op codes of the fused kernel (the values of ``repro_torch.kernels.ref``)
OP_IDENTITY = 0
OP_SIGRID_HASH = 1
OP_POSITIVE_MODULUS = 2
OP_CLAMP = 3
OP_BUCKETIZE = 4
OP_CLAMP_F = 5
OP_BUCKETIZE_F = 6

_I32_MIN = -(2 ** 31)
_I32_MAX = 2 ** 31 - 1
_MAX_BORDERS = 512
_F32_TINY = float(np.finfo(np.float32).tiny)   # smallest normal float32


def _subnormal(arr: np.ndarray) -> bool:
    """Values in (0, tiny): the reference's XLA paths flush them to zero
    (FTZ/DAZ) while numpy keeps them.  The port's kernel keeps them too
    (no --ftz), but the demotion stays so that the port's fused columns
    are exactly the reference's."""
    a = np.abs(arr, dtype=np.float32)
    return bool(np.any((a > 0) & (a < _F32_TINY)))


# ---------------------------------------------------------------------------
# Engine accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineStats:
    """Cumulative per-engine accounting (mirrored into ``WorkerMetrics``)."""

    fused_features: int = counter()      # op executions served by a fused kernel
    fallback_features: int = counter()   # op executions served by per-feature numpy
    demoted_features: int = counter()    # fused-eligible ops demoted at run time
    kernel_launches: int = counter()     # fused launches + per-feature op calls
    fused_s: float = counter(0.0)        # transform_s attribution: fused path
    fallback_s: float = counter(0.0)     # transform_s attribution: numpy path


# ---------------------------------------------------------------------------
# Compilation: transform DAG -> waves of packed fused ops + fallback steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedOp:
    """One packed column of a fused wave: op code + int32 params (float
    params ride as float32 bit patterns, like in the kernel)."""

    spec: TransformSpec
    code: int
    p0: int
    p1: int
    kind: str                              # "sparse" | "dense" | "dense_bucket"
    borders: Optional[np.ndarray] = None   # (nb,) float32, BUCKETIZE_F only


@dataclasses.dataclass(frozen=True)
class FusedWave:
    ops: Tuple[FusedOp, ...]


@dataclasses.dataclass(frozen=True)
class FallbackStep:
    spec: TransformSpec


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """Ordered execution steps: each step is a FusedWave (one kernel
    launch) or a FallbackStep (one per-feature numpy call)."""

    steps: Tuple[Union[FusedWave, FallbackStep], ...]

    @property
    def fused_ops(self) -> List[FusedOp]:
        return [op for s in self.steps if isinstance(s, FusedWave) for op in s.ops]

    @property
    def fallback_specs(self) -> List[TransformSpec]:
        return [s.spec for s in self.steps if isinstance(s, FallbackStep)]


def _f32_exact(x: Any) -> bool:
    try:
        x = float(x)
    except (TypeError, ValueError):
        return False
    # NaN params stay on the numpy path: the kernel's min/max NaN order
    # differs from numpy's.  (NaN != NaN, so the equality rejects it.)
    f = float(np.float32(x))
    return f == x


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


def _bits_f32(b: int) -> float:
    return float(np.int32(b).view(np.float32))


def _try_fuse(spec: TransformSpec) -> Optional[FusedOp]:
    """Static fusability: can this spec be expressed as one fused-kernel
    column with bit-exact numpy parity?  Returns None for fallback."""
    kw = spec.kwargs
    if len(spec.inputs) != 1:
        return None
    if spec.op == "SigridHash" and set(kw) == {"salt", "max_value"}:
        salt, mv = kw["salt"], kw["max_value"]
        if isinstance(salt, (int, np.integer)) and isinstance(mv, (int, np.integer)) \
                and 0 <= salt <= _I32_MAX and 1 <= mv <= _I32_MAX:
            return FusedOp(spec, OP_SIGRID_HASH, int(salt), int(mv), "sparse")
    elif spec.op == "PositiveModulus" and set(kw) == {"m"}:
        m = kw["m"]
        if isinstance(m, (int, np.integer)) and 1 <= m <= _I32_MAX:
            return FusedOp(spec, OP_POSITIVE_MODULUS, int(m), int(m), "sparse")
    elif spec.op == "Clamp" and set(kw) == {"lo", "hi"}:
        lo, hi = kw["lo"], kw["hi"]
        if (
            _f32_exact(lo) and _f32_exact(hi)
            and not _subnormal(np.array([lo, hi], np.float32))
        ):
            return FusedOp(
                spec, OP_CLAMP_F, _f32_bits(float(lo)), _f32_bits(float(hi)),
                "dense",
            )
    elif spec.op == "Bucketize" and set(kw) == {"borders"}:
        b = np.asarray(kw["borders"], np.float32)
        if (
            b.ndim == 1 and 1 <= b.size <= _MAX_BORDERS
            and np.all(np.isfinite(b)) and np.all(np.diff(b) >= 0)
            and not _subnormal(b)
        ):
            return FusedOp(spec, OP_BUCKETIZE_F, 0, 0, "dense_bucket", b)
    return None


def compile_pipeline(
    specs: Sequence[TransformSpec],
) -> CompiledPlan:
    """Greedy level scheduling: at every round, every not-yet-executed
    fusable spec whose inputs are already materialized joins one fused
    wave (one kernel launch); otherwise the next spec in topological
    order runs as a per-feature fallback.  DAGs that reassign an output
    key compile to pure fallback (wave reordering would change the
    sequential-overwrite semantics of ``TransformPipeline``)."""
    specs = list(specs)
    # single-assignment check with read-before-overwrite detection: if a
    # spec's output key was already read (by an earlier spec, or by itself)
    # or already written, sequential execution order is load-bearing — an
    # earlier reader must see the PRE-overwrite value, which wave
    # reordering would destroy.  ``{outputs} & ({inputs} - {outputs})``
    # is NOT sufficient: a later spec overwriting a raw batch key that an
    # earlier spec reads leaves that key out of the external set entirely.
    seen_inputs: set = set()
    written: set = set()
    for s in specs:
        seen_inputs.update(s.inputs)       # reads happen before this write
        if s.output in seen_inputs or s.output in written:
            return CompiledPlan(tuple(FallbackStep(s) for s in specs))
        written.add(s.output)
    external = {i for s in specs for i in s.inputs} - written

    fusable = {id(s): _try_fuse(s) for s in specs}
    avail = set(external)
    remaining = list(specs)
    steps: List[Union[FusedWave, FallbackStep]] = []
    while remaining:
        # drain every ready fallback FIRST: postponing fusable ops until no
        # fallback can run widens each wave (e.g. all FirstX feeds complete
        # before their SigridHashes fuse into ONE launch).  Safe because
        # single-assignment makes execution order irrelevant to results.
        progressed = True
        while progressed:
            progressed = False
            for s in list(remaining):
                if fusable[id(s)] is None and all(i in avail for i in s.inputs):
                    steps.append(FallbackStep(s))
                    avail.add(s.output)
                    remaining.remove(s)
                    progressed = True
        wave = [
            s for s in remaining
            if fusable[id(s)] is not None and all(i in avail for i in s.inputs)
        ]
        if not wave:
            # nothing ready at all: an unsatisfiable input.  Preserve the
            # sequential pipeline's behavior (KeyError at execution time).
            steps.extend(FallbackStep(s) for s in remaining)
            break
        # split by row class: sparse columns pack nnz values (~rows x
        # avg_len lanes) while dense columns pack one value per row —
        # co-packing would pad every dense column to the tallest nnz and
        # drag the borders compare over the tall tile.  Two well-shaped
        # launches beat one badly-shaped one; amortization stays
        # O(features) per launch.
        sparse_ops = tuple(
            fusable[id(s)] for s in wave if fusable[id(s)].kind == "sparse"
        )
        dense_ops = tuple(
            fusable[id(s)] for s in wave if fusable[id(s)].kind != "sparse"
        )
        for ops in (sparse_ops, dense_ops):
            if ops:
                steps.append(FusedWave(ops))
        for s in wave:
            avail.add(s.output)
            remaining.remove(s)
    return CompiledPlan(tuple(steps))


def decode_plan(plan: CompiledPlan) -> List[TransformSpec]:
    """Reconstruct the fused specs from their packed op-code/param columns
    — the round-trip witness that packing loses nothing (borders are
    canonicalized to float32, the precision the kernel compares in)."""
    out: List[TransformSpec] = []
    for op in plan.fused_ops:
        src = op.spec
        if op.code == OP_SIGRID_HASH:
            params = (("salt", op.p0), ("max_value", op.p1))
        elif op.code == OP_POSITIVE_MODULUS:
            params = (("m", op.p0),)
        elif op.code == OP_CLAMP_F:
            params = (("lo", _bits_f32(op.p0)), ("hi", _bits_f32(op.p1)))
        elif op.code == OP_BUCKETIZE_F:
            params = (("borders", op.borders),)
        else:  # pragma: no cover - no other codes are emitted by _try_fuse
            raise ValueError(f"unknown fused op code {op.code}")
        out.append(TransformSpec(src.op, src.inputs, src.output, params))
    return out


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


class TransformEngine:
    """Executes a session's transform DAG over a ColumnBatch."""

    name = "base"

    def __init__(self, pipeline: TransformPipeline):
        self.pipeline = pipeline
        self.stats = EngineStats()

    def run(self, batch: ColumnBatch) -> Dict[str, Column]:
        raise NotImplementedError

    def __call__(self, batch: ColumnBatch) -> Dict[str, Column]:
        return self.run(batch)

    # -- shared helpers -----------------------------------------------------

    @staticmethod
    def _seed_env(batch: ColumnBatch) -> Dict[str, Column]:
        env: Dict[str, Column] = {}
        for fid, col in batch.dense.items():
            env[f"f{fid}"] = col
        for fid, col in batch.sparse.items():
            env[f"f{fid}"] = col
        return env

    def _apply_fallback(self, spec: TransformSpec, env: Dict[str, Column]) -> None:
        t0 = time.perf_counter()
        fn = _OPS[spec.op]
        env[spec.output] = fn(*[env[i] for i in spec.inputs], **spec.kwargs)
        self.stats.fallback_s += time.perf_counter() - t0
        self.stats.fallback_features += 1
        self.stats.kernel_launches += 1


class NumpyEngine(TransformEngine):
    """Per-feature reference execution — one vectorized numpy call per
    spec, each accounted as one kernel launch (the per-feature dispatch
    regime of §7.2)."""

    name = "numpy"

    def run(self, batch: ColumnBatch) -> Dict[str, Column]:
        env = self._seed_env(batch)
        for spec in self.pipeline.specs:
            self._apply_fallback(spec, env)
        return env


class TorchEngine(TransformEngine):
    """Wave-fused execution via ``kernels.fused_transform``.

    ``device`` is where each wave runs: ``"cuda"`` (the default) launches
    the CUDA kernel and raises where CUDA is missing; ``"cpu"`` runs the
    plain PyTorch version, with the wave's op codes known so only the ops
    present are computed.  Both compute identical bits, so the engine
    stays byte-compatible with ``NumpyEngine``.

    ``row_quantum`` pads the packed tile's row count up to a multiple, so
    ragged stripe sizes reuse a handful of tile shapes (pad lanes compute
    garbage that is sliced away on unpack).
    """

    name = "torch"

    def __init__(
        self,
        pipeline: TransformPipeline,
        device: Union[str, torch.device] = "cuda",
        row_quantum: int = 512,
    ):
        super().__init__(pipeline)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchEngine(device='cuda') needs a CUDA device; "
                "pass device='cpu' to run the plain version"
            )
        self.plan = compile_pipeline(pipeline.specs)
        self.row_quantum = max(1, row_quantum)

    def run(self, batch: ColumnBatch) -> Dict[str, Column]:
        env = self._seed_env(batch)
        for step in self.plan.steps:
            if isinstance(step, FallbackStep):
                self._apply_fallback(step.spec, env)
            else:
                self._run_wave(step, env)
        return env

    # -- wave execution -----------------------------------------------------

    def _pack_column(self, fop: FusedOp, col: Column) -> Optional[np.ndarray]:
        """Return this op's input as int32-assignable lanes (int64 sparse
        ids wrap to their low 32 bits on assignment; dense float32 rides
        as bit patterns), or None to demote the op to the numpy fallback."""
        if fop.kind == "sparse":
            if not isinstance(col, SparseColumn):
                return None
            v = col.values
            if fop.code == OP_POSITIVE_MODULUS and v.size and (
                v.min() < _I32_MIN or v.max() > _I32_MAX
            ):
                return None      # int32 wrap would diverge from int64 numpy
            # SigridHash truncates to the low 32 bits on both paths, so
            # any int64 id packs exactly (setitem wrap == astype wrap).
            return v
        if not isinstance(col, np.ndarray) or col.ndim != 1:
            return None
        if fop.kind == "dense" and col.dtype != np.float32:
            return None          # f64 clamp-then-cast can diverge from f32
        v32 = np.nan_to_num(col, nan=0.0).astype(np.float32)
        if _subnormal(v32):
            return None          # the reference flushes subnormals (see _subnormal)
        return v32.view(np.int32)

    def _run_wave(self, wave: FusedWave, env: Dict[str, Column]) -> None:
        t0 = time.perf_counter()
        entries: List[Tuple[FusedOp, Column, np.ndarray]] = []
        demoted: List[FusedOp] = []
        for fop in wave.ops:
            col = env[fop.spec.inputs[0]]
            packed = self._pack_column(fop, col)
            if packed is None:
                demoted.append(fop)
            else:
                entries.append((fop, col, packed))

        if entries:
            rows = max(len(p) for _, _, p in entries)
            feats = len(entries)
            if rows == 0:
                out32 = np.zeros((feats, 0), np.int32)
            else:
                # features-major packing: one contiguous row per feature
                # (fast fills; int64 ids wrap to their low 32 bits on
                # assignment, matching the kernel's lane truncation)
                q = self.row_quantum
                rows_pad = -(-rows // q) * q
                mat = np.zeros((feats, rows_pad), np.int32)
                codes = np.zeros(feats, np.int32)
                p0 = np.zeros(feats, np.int32)
                p1 = np.zeros(feats, np.int32)
                nb = max(
                    [f.borders.size for f, _, _ in entries if f.borders is not None],
                    default=1,
                )
                borders = np.full((feats, nb), np.inf, np.float32)
                for j, (fop, _, packed) in enumerate(entries):
                    mat[j, : len(packed)] = packed
                    codes[j] = fop.code
                    p0[j] = fop.p0
                    p1[j] = fop.p1
                    if fop.borders is not None:
                        borders[j, : fop.borders.size] = fop.borders
                out32 = self._launch(mat, codes, p0, p1, borders)
            self.stats.kernel_launches += 1
            self.stats.fused_features += feats
            # vectorized unpack: at most one widening cast for the whole
            # wave; per-feature outputs are contiguous row views
            out64 = (
                out32.astype(np.int64)
                if any(f.kind != "dense" for f, _, _ in entries) else None
            )
            for j, (fop, col, packed) in enumerate(entries):
                env[fop.spec.output] = self._unpack(
                    fop, col, out32, out64, j, len(packed)
                )
            self.stats.fused_s += time.perf_counter() - t0

        for fop in demoted:
            self.stats.demoted_features += 1
            self._apply_fallback(fop.spec, env)

    def _launch(self, mat, codes, p0, p1, borders) -> np.ndarray:
        """Run one wave over the (features, rows) packed tile; returns the
        transformed tile in the same layout."""
        dev = self.device
        out = kops.fused_transform(
            torch.from_numpy(mat).to(dev), torch.from_numpy(codes).to(dev),
            torch.from_numpy(p0).to(dev), torch.from_numpy(p1).to(dev),
            torch.from_numpy(borders).to(dev), features_major=True,
        )
        return out.cpu().numpy()

    @staticmethod
    def _unpack(
        fop: FusedOp, col: Column,
        out32: np.ndarray, out64: Optional[np.ndarray], j: int, n: int,
    ) -> Column:
        if fop.kind == "sparse":
            return SparseColumn(
                offsets=col.offsets, values=out64[j, :n], scores=col.scores,
            )
        if fop.kind == "dense":        # Clamp: float32 bits back to floats
            return out32[j, :n].view(np.float32)
        # dense_bucket: one bucket id per row, arange offsets — exactly
        # the transforms.bucketize output shape
        return SparseColumn(
            offsets=np.arange(n + 1, dtype=np.int64),
            values=out64[j, :n], scores=None,
        )


ENGINES = {"numpy": NumpyEngine, "torch": TorchEngine}


def make_engine(
    engine: Union[str, TransformEngine, None],
    pipeline: TransformPipeline,
    device: Union[str, torch.device] = "cuda",
) -> TransformEngine:
    """Resolve an engine choice (name, instance, or factory) for one
    exclusive owner (engines accumulate stats; don't share instances
    across workers).  ``device`` places a ``"torch"`` engine."""
    if engine is None:
        return NumpyEngine(pipeline)
    if isinstance(engine, TransformEngine):
        return engine
    if isinstance(engine, str):
        try:
            cls = ENGINES[engine]
        except KeyError:
            raise ValueError(
                f"unknown transform engine {engine!r}; "
                f"expected one of {sorted(ENGINES)}"
            ) from None
        return cls(pipeline, device) if cls is TorchEngine else cls(pipeline)
    return engine(pipeline)      # factory callable
