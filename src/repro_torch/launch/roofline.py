"""Roofline terms of a step, from its op trace, on the H100.

A port of the reference's ``repro.launch.roofline``:

compute term    = flops / (chips * peak bf16 FLOP/s)
memory term     = bytes / (chips * HBM rate)
collective term = collective bytes on the wire a rank / link rate

The reference reads flops and bytes from XLA's cost analysis and the
collectives from the post-SPMD HLO text; here "HLO" is the op trace a
step leaves under a ``TorchDispatchMode`` (``launch.hlo_analysis``), and
the collectives are the log ``launch.mesh.record_collectives`` keeps of
what the mesh performed.  ``parse_collectives`` takes that log, not
text, and returns the reference's ``CollectiveStats``.  The ring model
(``_collective_wire``) is the reference's.  The link rate is NVLink's
where a group's ranks lie within one node of ``GPUS_PER_NODE``, the
inter-node port's otherwise; the constants are an H100 SXM's
(``launch.mesh``), not a TPU's.

``kernel_work`` is the one count of the work of each of the ten
kernels (``kernels/ops.py``): the operations and bytes its bound is
reckoned from (``kernel_bound``), and what the analyzer counts for a
kernel call on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.launch import mesh as meshlib

FP32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    wire_bytes_per_device: float     # ring-model bytes each device sends
    result_bytes: Dict[str, int]
    # the part of the wire bytes whose group spans nodes (inter-node rate)
    inter_node_wire_bytes: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _collective_wire(kind: str, nbytes: int, g: int) -> float:
    """Ring-model bytes a rank sends for one collective whose result is
    ``nbytes``, over a group of ``g`` ranks."""
    if g <= 1:
        return 0.0
    kind = kind.replace("-start", "")
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return float(nbytes)
    return 0.0


def parse_collectives(log: Iterable[meshlib.Collective]) -> CollectiveStats:
    """Counts, result bytes and ring-model wire bytes by kind of a
    recorded collective log (``launch.mesh.record_collectives``)."""
    counts: Dict[str, int] = {}
    result_bytes: Dict[str, int] = {}
    wire = inter = 0.0
    for c in log:
        counts[c.kind] = counts.get(c.kind, 0) + 1
        result_bytes[c.kind] = result_bytes.get(c.kind, 0) + c.nbytes
        w = _collective_wire(c.kind, c.nbytes, c.group)
        wire += w
        if not c.node_local:
            inter += w
    return CollectiveStats(counts=counts, wire_bytes_per_device=wire,
                           result_bytes=result_bytes, inter_node_wire_bytes=inter)


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # total flops (all devices)
    hbm_bytes: float             # total bytes accessed
    wire_bytes_per_device: float
    chips: int
    model_flops: float = 0.0     # 6*N*D useful flops
    # the part of the wire bytes a rank sends over the inter-node links
    inter_node_wire_bytes: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * meshlib.PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * meshlib.HBM_BW)

    @property
    def collective_s(self) -> float:
        inter = self.inter_node_wire_bytes
        return ((self.wire_bytes_per_device - inter) / meshlib.NVLINK_BW
                + inter / meshlib.INTER_NODE_BW)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time estimate: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if self.model_flops and self.flops:
            return self.model_flops / self.flops
        return None

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Fraction of chip peak spent on *useful* model flops at the
        roofline-predicted step time (MFU upper bound for this step)."""
        if not self.model_flops:
            return None
        t = self.step_time_s
        return self.model_flops / (t * self.chips * meshlib.PEAK_FLOPS_BF16)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "inter_node_wire_bytes": self.inter_node_wire_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_estimate(cfg: Any, shape: Any) -> float:
    """6*N_active*D for train; 2*N_active*D for prefill; 2*N_active*B for decode."""
    from repro_torch.models.common import param_count
    from repro_torch.models.dlrm import DLRM, DLRMConfig

    if isinstance(cfg, DLRMConfig):
        # the spec tree counts the tables; none is drawn
        n = param_count(DLRM(cfg, tables=False, device="meta").param_specs())
        # embedding lookups are sparse; MLP params dominate compute
        tokens = shape.global_batch
        return 6.0 * n * tokens * 1e-3  # rough: tables are lookup-bound
    n_active = cfg.active_params()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def attention_flops_estimate(cfg: Any, shape: Any) -> float:
    """Causal attention score+value flops (not in 6ND), for context."""
    from repro_torch.models.dlrm import DLRMConfig

    if isinstance(cfg, DLRMConfig) or getattr(cfg, "attention_free", False):
        return 0.0
    b, s = shape.global_batch, shape.seq_len
    h, d = cfg.num_heads, cfg.head_dim
    if cfg.family == "hybrid":
        layers = cfg.num_layers // cfg.block_period
    else:
        layers = cfg.num_layers
    if shape.mode == "train":
        return 3.0 * 2.0 * b * h * s * s * d * layers  # fwd+bwd, causal half
    if shape.mode == "prefill":
        return 2.0 * b * h * s * s * d * layers / 2
    return 2.0 * 2.0 * b * h * s * d * layers


# ---------------------------------------------------------------------------
# The kernels' work
# ---------------------------------------------------------------------------

def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _causal_pairs(s: int, t: int) -> int:
    """sum(min(i + 1, t) for i in range(s)): the (query, key) pairs a
    causal mask keeps."""
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


def _bag_rows(table: torch.Tensor, ids: torch.Tensor) -> int:
    """The table rows a bag launch reads: the distinct ids; on ``meta``,
    where ids have no values, every slot its own row (at most the table's
    rows), the most the call can read."""
    if ids.device.type == "meta":
        return min(ids.numel(), table.shape[0])
    return int(torch.unique(ids).numel())


def _codes(op_codes: Any) -> Tuple[int, ...]:
    if isinstance(op_codes, torch.Tensor):
        if op_codes.device.type == "meta":
            raise ValueError("fused_transform's work depends on its op codes: pass them as a "
                             "CPU tensor or a sequence when the tile is on meta")
        return tuple(int(c) for c in op_codes.tolist())
    return tuple(int(c) for c in op_codes)


def _work_fused_transform(ids, op_codes, param0, param1, borders=None, *,
                          features_major: bool = False):
    from repro_torch.kernels.ref import OP_BUCKETIZE_F

    # each tile word read and written once, the per-feature params read
    # once; ~12 integer ops a hashed, clamped or bucketized element and
    # one compare a border for BUCKETIZE_F
    rows = ids.shape[1] if features_major else ids.shape[0]
    nb = borders.shape[1] if borders is not None else 1
    ops = rows * sum(nb if c == OP_BUCKETIZE_F else 12 for c in _codes(op_codes))
    small = _nbytes(*(t for t in (op_codes, param0, param1, borders)
                      if isinstance(t, torch.Tensor)))
    return ops, 2 * _nbytes(ids) + small


def _work_xor_decrypt(words):
    return words.numel(), 2 * _nbytes(words)


def _work_dense_unpack(bitmap_words, values):
    out_elems = bitmap_words.shape[0] * bitmap_words.shape[1] * 32
    return 6 * out_elems, _nbytes(bitmap_words, values) + 4 * out_elems


def _work_ragged_gather(src, idx, shift):
    return 4 * idx.numel(), _nbytes(src, idx, shift) + _nbytes(idx)


def _work_embedding_bag(table, ids, mask, *, mode: str = "mean"):
    # the launch reads only the rows its ids name (every slot is read,
    # masked ones too), plus ids and mask, and writes the (b, e) output
    b, l = ids.shape
    e = table.shape[1]
    nbytes = _bag_rows(table, ids) * e * table.element_size() + _nbytes(ids, mask) + 4 * b * e
    return 2 * b * l * e, nbytes


def _work_flash_attention(q, k, v, *, causal: bool = True, scale=None):
    # bytes: q, k, v read once and out written once; operations: 2
    # products of 2*D flops for each (query, key) pair the mask keeps
    b, h, s, d = q.shape
    t = k.shape[2]
    pairs = b * h * (_causal_pairs(s, t) if causal else s * t)
    return 4 * d * pairs, _nbytes(q, k, v) + _nbytes(q)


def _work_ssd_chunk_forward(x, dt, a, b_, c_, *, chunk: int = 256, initial_state=None):
    # bytes: x, dt, A, B, C read once, y and the (B, H, P, N) float32
    # state written once; operations: the chunked form with the causal
    # half of each chunk's Q x Q products only (C.B^T and m.x over the
    # lower triangle, C.state and the state update in full)
    bsz, s, h, p = x.shape
    n = b_.shape[3]
    flops = 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        flops += q * (q + 1) // 2 * 2 * (n + p) + 4 * q * n * p
    flops *= bsz * h
    nbytes = (2 * x.numel() * x.element_size() + 2 * b_.numel() * b_.element_size()
              + 4 * bsz * s * h + 4 * h + 4 * bsz * h * p * n)
    return flops, nbytes


def _work_rowwise_adagrad_(table, acc, keys, weights, grad, lr, eps: float = 1e-8):
    # bytes: keys, weights and the gradient rows read once, each distinct
    # row the live occurrences name and its accumulator entry read and
    # written once; operations: 4 an element of each live occurrence
    # (product, sum, square, sum of squares) and 2 an element of each row.
    # On ``meta``, where keys have no values, every slot is live and its
    # own row (at most the table's rows): the most a call can do
    e = table.shape[1]
    if keys.device.type == "meta":
        live, rows = keys.numel(), min(keys.numel(), table.shape[0])
    else:
        named = keys[(keys >= 0) & (weights != 0)]
        live, rows = named.numel(), int(torch.unique(named).numel())
    nbytes = _nbytes(keys, weights, grad) + 2 * rows * (e * table.element_size()
                                                      + acc.element_size())
    return 4 * e * live + 2 * e * rows, nbytes


def _work_sigrid_hash(ids, salt, max_value):
    return 12 * ids.numel(), 8 * ids.numel()


def _work_bucketize(values, borders):
    return values.numel() * borders.numel(), 8 * values.numel() + 4 * borders.numel()


_WORK = {
    "fused_transform": _work_fused_transform,
    "xor_decrypt": _work_xor_decrypt,
    "dense_unpack": _work_dense_unpack,
    "ragged_gather": _work_ragged_gather,
    "embedding_bag": _work_embedding_bag,
    "flash_attention": _work_flash_attention,
    "ssd_chunk_forward": _work_ssd_chunk_forward,
    "sigrid_hash": _work_sigrid_hash,
    "bucketize": _work_bucketize,
    "rowwise_adagrad_": _work_rowwise_adagrad_,
}

# the peak each kernel's operations are held to: the tensor cores' bf16
# rate for the two LM kernels, float32 outside them for the data path
KERNEL_RATE = {name: FP32_OPS_PER_S for name in _WORK}
KERNEL_RATE.update(flash_attention=meshlib.PEAK_FLOPS_BF16,
                   ssd_chunk_forward=meshlib.PEAK_FLOPS_BF16)

KERNELS = tuple(_WORK)


def kernel_work(name: str, *operands: Any, **kw: Any) -> Tuple[int, int]:
    """(operations, bytes) of one call of kernel ``name`` (the name of its
    op in ``kernels/ops.py``) on ``operands``: each input read once and
    each output written once, and the operations its bound counts.  The
    counts follow the shapes, but for two kernels whose work follows the
    data: ``embedding_bag`` reads the rows its ids name (on ``meta``, the
    most it can read: every slot its own row), and ``fused_transform``
    counts by its op codes, which must have values."""
    if name not in _WORK:
        raise KeyError(f"no kernel {name!r}; the kernels are {KERNELS}")
    ops, nbytes = _WORK[name](*operands, **kw)
    return int(ops), int(nbytes)


def kernel_bound(name: str, *operands: Any, **kw: Any) -> Tuple[float, str, int, int]:
    """The least time one call can take on the card: (ms, "bytes" or
    "operations", operations, bytes), the larger of the bytes at
    ``HBM_BW`` and the operations at the kernel's peak (``KERNEL_RATE``)."""
    ops, nbytes = kernel_work(name, *operands, **kw)
    bytes_ms = nbytes / meshlib.HBM_BW * 1e3
    ops_ms = ops / KERNEL_RATE[name] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), ops, nbytes
