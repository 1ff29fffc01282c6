"""DPP data plane: stateless Workers (§3.2.1).

Per split: **extract** (read + decrypt + decompress + decode raw stream
chunks, filter unused features), **transform** (per-feature DAG via
high-performance vectorized kernels), and partially **load** (batch into
ready-to-serve tensors kept in a bounded in-memory buffer).

Splits are processed as a two-stage producer/consumer pipeline: a
producer thread streams one stripe at a time from storage
(``TableReader.iter_stripes``) into a small prefetch buffer while the
consumer overlaps transform + load on the previous stripe.  A split only
reads the stripes covering its own row range — never the whole partition.

Workers account bytes and CPU-time per ETL phase — the measurements behind
Table 9 ("Storage RX / Transform RX / TX") and Fig. 9's cycle breakdown —
plus per-stripe accounting (stripes read, rows decoded vs. rows served)
that makes read over-scoping measurable.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.dpp.master import (
    REPORT_DATA_ERROR,
    DPPMaster,
    SessionSpec,
    Split,
)
from repro_torch.core.decode import make_decode_engine
from repro_torch.core.engine import make_engine
from repro_torch.core.reader import TableReader
from repro_torch.core.transforms import materialize_dlrm_batch
from repro_torch.core.warehouse import Table
from repro_torch.obs import NULL_TRACER, counter, merge_metrics


@dataclasses.dataclass
class WorkerMetrics:
    storage_rx_bytes: int = counter()  # compressed, served by storage nodes
    cache_rx_bytes: int = counter()    # compressed, served by the stripe cache
    extract_out_bytes: int = counter() # decoded columnar bytes (transform RX)
    tx_bytes: int = counter()          # materialized tensor bytes (transform TX)
    extract_s: float = counter(0.0)
    transform_s: float = counter(0.0)
    load_s: float = counter(0.0)
    splits_done: int = counter()
    data_errors: int = counter()       # splits reported as data_error
    rows_done: int = counter()         # rows served to clients
    stripes_read: int = counter()      # stripes fetched + decoded
    rows_decoded: int = counter()      # stripe rows decoded (incl. trim waste)
    rows_from_cache: int = counter()   # rows served by tensor-cache hits
    # per-engine transform accounting (mirrored from EngineStats — §7.2):
    fused_features: int = counter()            # ops served by fused kernels
    fallback_features: int = counter()         # ops served per-feature
    kernel_launches: int = counter()           # fused + per-feature calls
    transform_fused_s: float = counter(0.0)    # transform_s: fused path
    transform_fallback_s: float = counter(0.0) # transform_s: numpy path
    # per-engine extract accounting (mirrored from DecodeStats):
    extract_fused_s: float = counter(0.0)      # decode: batched-kernel path
    extract_fallback_s: float = counter(0.0)   # decode: per-stream path
    decode_launches: int = counter()           # decode kernel launches
    # per-extent I/O sizes of this worker's stripe fetches (Table 6)
    io_sizes: List[int] = counter(factory=list)

    def merge(self, o: "WorkerMetrics") -> None:
        # summing behavior comes from the per-field counter/gauge
        # metadata, not from blindly adding every dataclass field
        merge_metrics(self, o)

    @property
    def busy_s(self) -> float:
        return self.extract_s + self.transform_s + self.load_s

    @property
    def ingest_rx_bytes(self) -> int:
        """Total compressed bytes ingested, whatever tier served them."""
        return self.storage_rx_bytes + self.cache_rx_bytes

    @property
    def cache_served_frac(self) -> float:
        total = self.ingest_rx_bytes
        return self.cache_rx_bytes / total if total else 0.0

    @property
    def over_read_ratio(self) -> float:
        """Rows decoded per storage-served row (cache hits excluded);
        1.0 = perfectly split-scoped reads."""
        storage_rows = self.rows_done - self.rows_from_cache
        if storage_rows <= 0:
            return 1.0      # nothing read from storage: nothing over-read
        return self.rows_decoded / storage_rows

    @property
    def fused_frac(self) -> float:
        """Fraction of transform op executions served by fused kernels."""
        total = self.fused_features + self.fallback_features
        return self.fused_features / total if total else 0.0

    def cycle_breakdown(self) -> Dict[str, float]:
        t = max(self.busy_s, 1e-9)
        return {
            "extraction": self.extract_s / t,
            "transformation": self.transform_s / t,
            "load_misc": self.load_s / t,
        }


class DPPWorker:
    """Stateless worker: pulls splits, produces tensor batches into a buffer."""

    # deliberately lock-free (REPRO-R001 / racedep allowlist): `alive`
    # and `retired` are GIL-atomic monotone booleans — `alive` is
    # written only by the worker loop on exit, `retired` only by the
    # session monitor on scale-down, and readers tolerate staleness by
    # design (a late read means one extra poll, never lost data);
    # `_thread` is written once by the launching thread in start()
    _unshared = ("alive", "retired", "_thread")

    def __init__(
        self,
        worker_id: str,
        master: DPPMaster,
        table: Table,
        buffer_size: int = 8,
        fail_after_splits: Optional[int] = None,   # fault-injection hook
        tensor_cache=None,                         # shared TensorCache (§7.5)
        prefetch_stripes: int = 2,                 # extract-ahead depth
        tenant: Optional[str] = None,              # owning job for cache shares
        engine="torch",                            # TransformEngine name/factory
        decode_engine="torch",                     # DecodeEngine name/factory
        double_buffer: bool = True,                # overlap fetch N+1 / decode N
        tracer=NULL_TRACER,                        # span Tracer (obs layer)
        device="cuda",                             # where "torch" engines run
    ):
        self.worker_id = worker_id
        self.master = master
        self.table = table
        self.tenant = tenant
        self.tracer = tracer
        self.spec = master.spec
        self.pipeline = self.spec.pipeline()       # pulled from Master at startup
        self.device = device
        # transform stage executor (§7.2): "numpy" = per-feature reference,
        # "torch" = wave-fused kernel launches; engines are byte-identical
        self.engine = make_engine(engine, self.pipeline, device)
        # extract-stage decode strategy, same contract (see
        # repro_torch.core.decode), resolved when the worker's reader is built
        self.decode_engine = decode_engine
        self.double_buffer = double_buffer
        self.buffer: "queue.Queue[Dict[str, np.ndarray]]" = queue.Queue(buffer_size)
        self.metrics = WorkerMetrics()
        self.fail_after_splits = fail_after_splits
        self.tensor_cache = tensor_cache
        self.prefetch_stripes = max(1, prefetch_stripes)
        self._stop = threading.Event()
        self._drain = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.alive = True
        self.retired = False        # scale-down victim: don't health-restart

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def drain(self) -> None:
        """Graceful scale-down: stop pulling new splits but finish —
        and deliver — the one in flight.  ``stop()`` by contrast abandons
        undelivered batches (its split is never reported ``ok``, so a
        hard-stopped worker's split is re-dispatched, not lost)."""
        self._drain.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread:
            self._thread.join(timeout)

    # -- main loop ------------------------------------------------------------

    def _run(self) -> None:
        reader = TableReader(
            self.table, list(self.spec.feature_ids), record_popularity=False,
            tenant=self.tenant, tracer=self.tracer,
            decode_engine=make_decode_engine(self.decode_engine, self.device),
            double_buffer=self.double_buffer,
        )
        while not self._stop.is_set():
            if self._drain.is_set():
                break       # graceful exit: current split already delivered
            if (
                self.fail_after_splits is not None
                and self.metrics.splits_done >= self.fail_after_splits
            ):
                self.alive = False  # simulated crash: stop heartbeating
                return
            split = self.master.get_split(self.worker_id)
            if split is None:
                if self.master.finished:
                    break
                time.sleep(0.01)
                continue
            try:
                batches = self.process_split(reader, split)
            except Exception:
                # Extract/transform raised on this split's bytes.  The
                # worker is fine — only the data is suspect — so report a
                # typed data_error with the traceback (distinct from a
                # lease expiry, which signals a LOST worker) and move on
                # to the next split instead of dying and forcing a
                # restart-and-retry livelock.
                self.metrics.data_errors += 1
                self.master.complete_split(
                    self.worker_id, split.split_id,
                    status=REPORT_DATA_ERROR, error=traceback.format_exc(),
                )
                continue
            delivered = True
            for batch in batches:
                placed = False
                while not self._stop.is_set():
                    try:
                        self.buffer.put(batch, timeout=0.1)
                        placed = True
                        break
                    except queue.Full:
                        # back-pressured on a full buffer, not lost: the
                        # heartbeat extends our lease so the Master never
                        # charges a slow consumer as a dead worker
                        self.master.heartbeat(self.worker_id)
                        continue
                if not placed:
                    delivered = False   # hard-stopped mid-delivery
                    break
            if delivered:
                self.master.complete_split(self.worker_id, split.split_id)
            # else: no ok report — the lease lapses and the split is
            # re-dispatched rather than marked done with dropped batches
        self.alive = False

    # -- ETL -------------------------------------------------------------------

    def process_split(self, reader: TableReader, split: Split):
        """Extract + transform + batch one split; returns tensor minibatches.

        Two-stage pipeline: a producer thread streams the split's stripes
        from storage into a bounded prefetch queue; this (consumer) thread
        overlaps transform + load on already-extracted stripes.  Batch
        boundaries are identical to a monolithic read: full ``batch_size``
        chunks over the split's rows, one partial batch at the end.
        """
        meta = self.table.partitions[split.partition]

        if self.tensor_cache is not None:
            from repro_torch.core.dpp.tensor_cache import TensorCache

            # generation-aware key: a partition rewrite bumps
            # ``meta.generation``, so post-rewrite splits can never be
            # served the pre-rewrite preprocessed tensors.  A hit returns
            # before any extract or transform: no kernel is launched
            key = TensorCache.key(self.spec, split, meta.generation)
            cached = self.tensor_cache.get(key)
            if cached is not None:
                self.metrics.splits_done += 1
                self.metrics.rows_done += split.row_end - split.row_start
                self.metrics.rows_from_cache += split.row_end - split.row_start
                return cached

        t_split0 = time.perf_counter()
        prefetch: "queue.Queue" = queue.Queue(self.prefetch_stripes)
        abort = threading.Event()   # consumer died: let the producer exit

        def _put(item) -> bool:
            while not abort.is_set():
                try:
                    prefetch.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _produce() -> None:
            try:
                t0 = time.perf_counter()
                for sr in reader.iter_stripes(meta, split.row_start, split.row_end):
                    t1 = time.perf_counter()
                    if not _put((sr, t1 - t0)):
                        return
                    t0 = time.perf_counter()
                _put((_EOS, 0.0))
            except BaseException as e:  # surface extraction failures
                _put((e, 0.0))

        producer = threading.Thread(target=_produce, daemon=True)
        producer.start()

        m = self.metrics
        bs = self.spec.batch_size
        split_labeled: Optional[bool] = None   # first stripe sets the law
        out: List[Dict[str, np.ndarray]] = []
        # transformed stripes awaiting batch emission: (env, labels, rows).
        # Concatenated once per emission, not once per stripe, so carry rows
        # are not re-copied for every stripe that arrives.
        pending: List[Tuple[Dict[str, Any], Optional[np.ndarray], int]] = []
        pending_rows = 0
        n_served = 0

        def _emit(env, labels, start, stop):
            sub_env = _slice_env(env, start, stop)
            tensors = materialize_dlrm_batch(
                sub_env,
                self.spec.dense_keys,
                self.spec.sparse_keys,
                self.spec.max_ids_per_feature,
                labels=labels[start:stop] if labels is not None else None,
            )
            out.append(tensors)

        def _drain(final: bool) -> None:
            nonlocal pending, pending_rows, n_served
            if pending_rows == 0 or (not final and pending_rows < bs):
                return
            env = _concat_envs([p[0] for p in pending])
            labels = _concat_labels(pending)
            start = 0
            while pending_rows - start >= bs:
                _emit(env, labels, start, start + bs)
                start += bs
            if final and start < pending_rows:
                _emit(env, labels, start, pending_rows)
                start = pending_rows
            n_served += start
            if start < pending_rows:
                pending = [(
                    _slice_env(env, start, pending_rows),
                    labels[start:pending_rows] if labels is not None else None,
                    pending_rows - start,
                )]
            else:
                pending = []
            pending_rows -= start

        try:
            while True:
                item, extract_dt = prefetch.get()
                if item is _EOS:
                    break
                if isinstance(item, BaseException):
                    raise item
                sr = item
                # long splits must not look like lost workers mid-ETL
                self.master.heartbeat(self.worker_id)
                m.extract_s += extract_dt
                m.storage_rx_bytes += sr.bytes_from_storage
                m.cache_rx_bytes += sr.bytes_from_cache
                m.stripes_read += 1
                m.rows_decoded += sr.rows_decoded
                m.io_sizes.extend(sr.io_sizes)
                m.extract_out_bytes += sr.batch.nbytes()

                t2 = time.perf_counter()
                env = self.engine.run(sr.batch)
                t3 = time.perf_counter()
                m.transform_s += t3 - t2
                # engine counters are cumulative per exclusive engine, so a
                # straight mirror keeps the worker metric cumulative too
                es = self.engine.stats
                if self.tracer.enabled:
                    # before the mirror below, m still holds the previous
                    # cumulative per-path seconds — the difference is this
                    # stripe's fused/fallback attribution
                    self._trace_transform(t2, t3, es, m, split.split_id)
                m.fused_features = es.fused_features
                m.fallback_features = es.fallback_features
                m.kernel_launches = es.kernel_launches
                m.transform_fused_s = es.fused_s
                m.transform_fallback_s = es.fallback_s

                # per-SPLIT label uniformity, checked at stripe arrival:
                # the _concat_labels guard below only sees one drain window
                # at a time, so a label transition landing exactly on a
                # batch-aligned boundary would slip through it silently
                stripe_labeled = sr.batch.labels is not None
                if split_labeled is None:
                    split_labeled = stripe_labeled
                elif stripe_labeled != split_labeled:
                    raise ValueError(
                        "mixed labeled/unlabeled stripes within one split: "
                        f"stripe at rows [{sr.row_start}, {sr.row_end}) is "
                        f"{'labeled' if stripe_labeled else 'unlabeled'} but "
                        "the split started "
                        f"{'labeled' if split_labeled else 'unlabeled'}"
                    )
                pending.append((env, sr.batch.labels, sr.batch.num_rows))
                pending_rows += sr.batch.num_rows
                _drain(final=False)
                t_load = time.perf_counter()
                m.load_s += t_load - t3
                if self.tracer.enabled:
                    self.tracer.record(
                        "load.materialize", t3, t_load,
                        tenant=self.tenant or "", worker=self.worker_id,
                        split=split.split_id,
                    )
        except BaseException:
            abort.set()   # unblock the producer; it exits without a consumer
            raise

        producer.join()
        # decode-engine counters are cumulative per exclusive reader, so a
        # straight mirror (like the transform mirror above) keeps the
        # worker metric cumulative; done once the producer is quiescent
        ds = reader.decode.stats
        m.extract_fused_s = ds.fused_s
        m.extract_fallback_s = ds.fallback_s
        m.decode_launches = ds.kernel_launches
        t4 = time.perf_counter()
        _drain(final=True)
        t_load = time.perf_counter()
        m.load_s += t_load - t4
        if self.tracer.enabled:
            self.tracer.record(
                "load.materialize", t4, t_load,
                tenant=self.tenant or "", worker=self.worker_id,
                split=split.split_id,
            )

        if self.tensor_cache is not None:
            self.tensor_cache.put(key, out, cpu_s=time.perf_counter() - t_split0)

        m.tx_bytes += sum(sum(a.nbytes for a in b.values()) for b in out)
        m.splits_done += 1
        m.rows_done += n_served
        return out

    def _trace_transform(self, t0: float, t1: float, es, m: WorkerMetrics,
                         split_id: int) -> None:
        """Record this stripe's transform interval, partitioned into
        fused/fallback spans by the engine's per-path second deltas
        (``m`` must still hold the pre-mirror cumulative values)."""
        d_fused = es.fused_s - m.transform_fused_s
        d_fallback = es.fallback_s - m.transform_fallback_s
        labels = dict(tenant=self.tenant or "", worker=self.worker_id,
                      split=split_id)
        total = d_fused + d_fallback
        if total <= 0.0:
            self.tracer.record("transform.fallback", t0, t1, **labels)
            return
        cut = t0 + (t1 - t0) * (d_fused / total)
        if d_fused > 0.0:
            self.tracer.record("transform.fused", t0, cut, **labels)
        if d_fallback > 0.0:
            self.tracer.record("transform.fallback", cut, t1, **labels)

    # -- serving to clients ------------------------------------------------------

    def get_batch(self, timeout: float = 0.5) -> Optional[Dict[str, np.ndarray]]:
        try:
            return self.buffer.get(timeout=timeout)
        except queue.Empty:
            return None

    @property
    def buffered(self) -> int:
        return self.buffer.qsize()


_EOS = object()   # end-of-stripes sentinel for the prefetch queue


def _concat_envs(envs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Row-concatenate transform environments (pending stripes, in order)."""
    from repro_torch.core.schema import SparseColumn, concat_sparse_columns

    if len(envs) == 1:
        return envs[0]
    out: Dict[str, Any] = {}
    for k, v0 in envs[0].items():
        if isinstance(v0, SparseColumn):
            out[k] = concat_sparse_columns([e[k] for e in envs])
        else:
            out[k] = np.concatenate([e[k] for e in envs], axis=0)
    return out


def _concat_labels(
    pending: List[Tuple[Dict[str, Any], Optional[np.ndarray], int]]
) -> Optional[np.ndarray]:
    has_labels = [labels is not None for _, labels, _ in pending]
    if not any(has_labels):
        return None
    if not all(has_labels):
        # fabricating zeros for the unlabeled stripes would silently
        # corrupt training targets — a split must be uniformly labeled
        raise ValueError(
            "mixed labeled/unlabeled stripes within one split: "
            f"{sum(has_labels)}/{len(has_labels)} stripes carry labels"
        )
    if len(pending) == 1:
        return pending[0][1]
    return np.concatenate([labels for _, labels, _ in pending])


def _slice_env(env: Dict[str, Any], start: int, stop: int) -> Dict[str, Any]:
    from repro_torch.core.schema import SparseColumn

    out = {}
    for k, v in env.items():
        if isinstance(v, SparseColumn):
            off = v.offsets[start: stop + 1]
            out[k] = SparseColumn(
                offsets=off - off[0],
                values=v.values[off[0]: off[-1]],
                scores=v.scores[off[0]: off[-1]] if v.scores is not None else None,
            )
        else:
            out[k] = v[start:stop]
    return out
