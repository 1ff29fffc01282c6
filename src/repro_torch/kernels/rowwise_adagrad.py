"""CUDA kernel: the row-wise AdaGrad table update of the sparse DLRM step
(``csrc/rowwise_adagrad.cu``).

It replaces no TPU kernel: the reference updates its tables with XLA
scatter-adds (``repro.models.dlrm``'s ``sparse_table_update``), whose
plain PyTorch form (``kernels.ref.rowwise_adagrad_``) expands d(pooled)
into a per-slot (N, E) gradient and scatters it with ``index_add_``.
This kernel makes one sorted, deduplicated pass instead (the source's
note says how): each occurrence (m, l) names row ``keys[m, l]`` of the
(R, E) table (none where it is negative) with gradient
``weights[m, l] * grad[m]``; every distinct row's accumulator entry and
row are read and written once, by one warp or block, with no float
atomics, so two runs give the same bits, and each occurrence is added to
its row in turn, in slot order, rounded as the plain form rounds it.
Scratch is O(N) scalars (~44 bytes an occurrence with the sort's); no
(N, E) tensor is made.

``rowwise_adagrad_`` takes CUDA tensors only, checks them, launches on
the current stream (keys, a stable ``torch.sort``, then rows and carries)
with no host synchronisation: ``lr`` may be a 0-d device tensor, read
through its pointer.  Each call counts one launch in ``build.LAUNCHES``
(``rowwise_adagrad``) and adds, on the device, its live occurrences and
the distinct rows it updated to ``TALLY``, which the host reads only
after a run.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import torch

from repro_torch.kernels import build

MAX_EMBED_DIM = 512      # four 128-column stripes of float4s a lane
ALIGN = 16               # bytes: table and gradient rows are read as float4s
CHUNK = 32               # sorted occurrences a warp


class DeviceTally:
    """Two int64 counters a device, added to by the kernel: the live
    occurrences (those the update reads) and the distinct rows updated.
    Reading them waits for the device, so a run reads them after its
    window, never inside a step."""

    NAMES = ("occurrences", "rows")

    def __init__(self):
        self._lock = threading.Lock()
        self._t: Dict[torch.device, torch.Tensor] = {}

    def counters(self, device: torch.device) -> torch.Tensor:
        with self._lock:
            if device not in self._t:
                self._t[device] = torch.zeros(2, dtype=torch.int64, device=device)
            return self._t[device]

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """{device: {"occurrences": n, "rows": n}}; synchronises."""
        with self._lock:
            items = list(self._t.items())
        return {str(d): dict(zip(self.NAMES, t.tolist())) for d, t in items}

    def reset(self) -> None:
        with self._lock:
            for t in self._t.values():
                t.zero_()


TALLY = DeviceTally()


def rowwise_adagrad_(table: torch.Tensor, acc: torch.Tensor, keys: torch.Tensor,
                     weights: torch.Tensor, grad: torch.Tensor,
                     lr: Union[float, torch.Tensor], eps: float = 1e-8):
    """Row-wise AdaGrad in place: table (R, E) and acc (R,) float32, keys
    (M, L) int32, weights (M, L) and grad (M, E) float32, all on one CUDA
    device; E a multiple of 4 up to 512, 16-byte aligned table and grad.
    Returns (table, acc)."""
    _check(table, acc, keys, weights, grad, lr)
    m, l = keys.shape
    n = m * l
    rows, e = table.shape
    if n == 0:
        return table, acc
    dev = table.device
    if isinstance(lr, torch.Tensor) and lr.device == dev:
        lr_t = lr.reshape(()).to(torch.float32)
    else:
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        marked = torch.empty(n, dtype=torch.int32, device=dev)
        err = lib.rowwise_adagrad_keys_launch(
            keys.data_ptr(), weights.data_ptr(), grad.data_ptr(), marked.data_ptr(),
            m, l, e, rows, stream)
        build.check("rowwise_adagrad_keys", err)
        skeys, slots = torch.sort(marked, stable=True)
        sbag = torch.empty(n, dtype=torch.int32, device=dev)
        sw = torch.empty(n, dtype=torch.float32, device=dev)
        part_sq = torch.empty(2 * -(-n // CHUNK), dtype=torch.float32, device=dev)
        err = lib.rowwise_adagrad_rows_launch(
            skeys.data_ptr(), slots.data_ptr(), weights.data_ptr(), grad.data_ptr(),
            table.data_ptr(), acc.data_ptr(), lr_t.data_ptr(), float(eps), sbag.data_ptr(),
            sw.data_ptr(), part_sq.data_ptr(), TALLY.counters(dev).data_ptr(), n, l, e, stream)
    build.check("rowwise_adagrad", err)
    build.LAUNCHES.add("rowwise_adagrad")
    return table, acc


def _check(table, acc, keys, weights, grad, lr) -> None:
    for name, t, dtype, dim in (("table", table, torch.float32, 2), ("acc", acc, torch.float32, 1),
                                ("keys", keys, torch.int32, 2),
                                ("weights", weights, torch.float32, 2),
                                ("grad", grad, torch.float32, 2)):
        if t.device.type != "cuda":
            raise ValueError(f"rowwise_adagrad_ {name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"rowwise_adagrad_ {name}: expected a contiguous {dim}-D {dtype} "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if not (table.device == acc.device == keys.device == weights.device == grad.device):
        raise ValueError("rowwise_adagrad_: operands on different devices")
    rows, e = table.shape
    m, l = keys.shape
    if e % 4 or not 4 <= e <= MAX_EMBED_DIM:
        raise ValueError(f"rowwise_adagrad_: E = {e} must be a multiple of 4 up to "
                         f"{MAX_EMBED_DIM}")
    if table.data_ptr() % ALIGN or grad.data_ptr() % ALIGN:
        raise ValueError(f"rowwise_adagrad_: table and grad must be {ALIGN}-byte aligned")
    if acc.shape != (rows,) or rows >= 2 ** 31:
        raise ValueError(f"rowwise_adagrad_: acc {tuple(acc.shape)} must be ({rows},), and "
                         f"the table's rows fewer than 2^31 (int32 keys)")
    if weights.shape != keys.shape or grad.shape != (m, e):
        raise ValueError(f"rowwise_adagrad_: keys {tuple(keys.shape)}, weights "
                         f"{tuple(weights.shape)} and grad {tuple(grad.shape)} must be (M, L), "
                         f"(M, L) and (M, {e})")
    if m * l >= 2 ** 31:
        raise ValueError(f"rowwise_adagrad_: {m} x {l} occurrences too many for one launch")
    if isinstance(lr, torch.Tensor) and lr.numel() != 1:
        raise ValueError(f"rowwise_adagrad_: lr must be a scalar, got {tuple(lr.shape)}")
