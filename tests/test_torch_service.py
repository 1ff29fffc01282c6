"""The port's multi-tenant DPP tier against the reference: sessions with a
tensor cache or the stripe prefetcher, ``DPPService`` tenants sharing one
stripe cache, the stall report and its traced smoke run, and the two
``examples/torch/`` scripts.

The port runs on the CPU (``device="cpu"``: its torch engines take their
kernels' plain versions); the reference runs on its numpy engines.  Served
batches are compared byte for byte, as a multiset (workers race).  Counts
that depend on the thread schedule (cache hits, which tenant fills a
stripe) are held to the reference's own invariants, not to equality.
"""
import hashlib
import json
import re
import runpy
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro.core import dwrf as j_dwrf  # noqa: E402
from repro.core.cache import StripeCache as JStripeCache  # noqa: E402
from repro.core.datagen import DataGenConfig as JDataGenConfig  # noqa: E402
from repro.core.dpp import DPPService as JService  # noqa: E402
from repro.core.dpp import DPPSession as JSession  # noqa: E402
from repro.core.dpp import SessionSpec as JSpec  # noqa: E402
from repro.core.dpp.tensor_cache import TensorCache as JTensorCache  # noqa: E402
from repro.core.schema import make_schema as j_make_schema  # noqa: E402
from repro.core.transforms import default_dlrm_pipeline as j_pipeline  # noqa: E402
from repro.core.warehouse import Warehouse as JWarehouse  # noqa: E402
from repro.obs import report as j_report  # noqa: E402
from repro.obs.smoke import run_smoke as j_run_smoke  # noqa: E402
from repro_torch.core import dwrf as t_dwrf  # noqa: E402
from repro_torch.core.cache import StripeCache as TStripeCache  # noqa: E402
from repro_torch.core.datagen import DataGenConfig as TDataGenConfig  # noqa: E402
from repro_torch.core.dpp import DPPService as TService  # noqa: E402
from repro_torch.core.dpp import DPPSession as TSession  # noqa: E402
from repro_torch.core.dpp import SessionSpec as TSpec  # noqa: E402
from repro_torch.core.dpp.tensor_cache import TensorCache as TTensorCache  # noqa: E402
from repro_torch.core.engine import TorchEngine  # noqa: E402
from repro_torch.core.schema import make_schema as t_make_schema  # noqa: E402
from repro_torch.core.transforms import default_dlrm_pipeline as t_pipeline  # noqa: E402
from repro_torch.core.warehouse import Warehouse as TWarehouse  # noqa: E402
from repro_torch.obs import report as t_report  # noqa: E402
from repro_torch.obs.smoke import run_smoke as t_run_smoke  # noqa: E402

pytestmark = pytest.mark.lockdep

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {
    "reference": dict(dwrf=j_dwrf, gen=JDataGenConfig, service=JService, session=JSession,
                      spec=JSpec, stripe_cache=JStripeCache, tensor_cache=JTensorCache,
                      schema=j_make_schema, pipeline=j_pipeline, warehouse=JWarehouse,
                      engines={}),
    "port": dict(dwrf=t_dwrf, gen=TDataGenConfig, service=TService, session=TSession,
                 spec=TSpec, stripe_cache=TStripeCache, tensor_cache=TTensorCache,
                 schema=t_make_schema, pipeline=t_pipeline, warehouse=TWarehouse,
                 engines={"device": "cpu"}),
}


def _table(m, name, n_partitions=2, rows=512, stripe=128, n_dense=16, n_sparse=6, seed=3,
           data_seed=4):
    wh = m["warehouse"]()
    t = wh.create_table(m["schema"](name, n_dense, n_sparse, seed=seed))
    t.generate(n_partitions, m["gen"](rows_per_partition=rows, seed=data_seed),
               m["dwrf"].DwrfWriterOptions(flattened=True, stripe_rows=stripe))
    return wh, t


def _spec(m, t, batch_size=128, rows_per_split=128, n_dense=4, n_sparse=2, **kw):
    """``tests/test_cache.py``'s ``_spec``."""
    dense = t.schema.dense_ids[:n_dense]
    sparse = t.schema.sparse_ids[:n_sparse]
    pipe = m["pipeline"](dense, sparse, hash_size=500)
    d = dict(
        table=t.schema.name, partitions=tuple(t.partitions),
        feature_ids=tuple(pipe.required_features()), transform_specs=tuple(pipe.specs),
        batch_size=batch_size, rows_per_split=rows_per_split,
        dense_keys=tuple(f"d{f}" for f in dense),
        sparse_keys=tuple(f"s{f}" for f in sparse), max_ids_per_feature=8,
    )
    d.update(kw)
    return m["spec"](**d)


def _digest(batch) -> str:
    h = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(batch[k])
        h.update(f"{k}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _digests(batches):
    return sorted(map(_digest, batches))


# -- sessions: tensor cache and prefetch ------------------------------------


def test_tensor_cache_serves_a_second_job_wholly_from_the_cache():
    """``tests/test_extensions.py``'s cross-job test in both packages: the
    second job's splits are all cache hits, its batches are the first's,
    byte for byte, and both packages serve the same bytes."""
    def run(m):
        _, t = _table(m, "tc", n_partitions=1, n_dense=16, n_sparse=4, seed=0, data_seed=1)
        spec = _spec(m, t, partitions=(0,))
        cache = m["tensor_cache"](capacity_bytes=64 * 1024 * 1024)
        outs, metrics = [], []
        for _ in range(2):
            sess = m["session"](spec, t, n_workers=1, tensor_cache=cache, **m["engines"])
            outs.append(sess.run_to_completion(timeout_s=60))
            metrics.append(sess.worker_metrics())
        return outs, metrics, cache.stats

    (ref_outs, ref_m, ref_stats), (outs, mets, stats) = (
        run(PACKAGES["reference"]), run(PACKAGES["port"]))
    assert (stats.misses, stats.hits) == (ref_stats.misses, ref_stats.hits) == (4, 4)
    assert stats.bytes_stored == ref_stats.bytes_stored
    assert stats.cpu_s_saved > 0
    assert mets[0].rows_from_cache == 0 and mets[1].rows_from_cache == 512
    assert mets[1].rows_done == 512 and mets[1].rows_decoded == 0
    assert _digests(outs[1]) == _digests(outs[0]) == _digests(ref_outs[0])
    assert ref_m[1].rows_from_cache == 512


def test_session_with_prefetch_serves_identical_batches():
    """The prefetcher changes where bytes come from, never the batches:
    with and without it the port serves the reference's bytes."""
    def run(m, prefetch):
        wh, t = _table(m, "pfs", rows=1024, stripe=256, n_dense=20, seed=0, data_seed=1)
        svc = m["service"](wh, stripe_cache=m["stripe_cache"]())
        spec = _spec(m, t, batch_size=256, rows_per_split=256, n_dense=6, n_sparse=3)
        sess = svc.create_session("j", spec, n_workers=2, prefetch=prefetch, **m["engines"])
        out = sess.run_to_completion(timeout_s=60)
        return out, sess

    ref, _ = run(PACKAGES["reference"], False)
    for prefetch in (False, True):
        out, sess = run(PACKAGES["port"], prefetch)
        assert sum(b["label"].shape[0] for b in out) == 2 * 1024
        assert _digests(out) == _digests(ref)
        if prefetch:
            assert sess.prefetcher.metrics.plans > 0
            assert sess.prefetcher._thread is not None     # started, stopped with the session
        else:
            assert sess.prefetcher is None


# -- DPPService ---------------------------------------------------------------


def _service_run(m, enable_stripe_cache):
    wh, t = _table(m, "cs")
    svc = m["service"](wh, enable_stripe_cache=enable_stripe_cache)
    for i in range(2):
        svc.create_session(f"j{i}", _spec(m, t), n_workers=2, **m["engines"])
    return svc, svc.run_all(timeout_s=60)


def test_two_tenants_share_the_stripe_cache_like_the_reference():
    """``tests/test_cache.py``'s concurrent-sessions test, port against
    reference.  Exact: each tenant's batches and the fleet's storage and
    ingest bytes without the cache.  Invariants (the thread schedule
    decides which tenant fills a stripe): over-read 1.0, storage halved by
    the cache, hit rate at least 0.5, per-tenant bytes summing to the
    tier totals."""
    ref_svc, ref_res = _service_run(PACKAGES["reference"], True)
    off_svc, off_res = _service_run(PACKAGES["port"], False)
    svc, res = _service_run(PACKAGES["port"], True)
    m0, m1 = off_svc.fleet_metrics(), svc.fleet_metrics()
    assert sorted(res) == sorted(ref_res) == ["j0", "j1"]
    for name in res:
        assert len(res[name]) == 8
        assert _digests(res[name]) == _digests(ref_res[name]) == _digests(off_res[name])
    assert m0.storage_rx_bytes == ref_svc.fleet_metrics().ingest_rx_bytes
    assert m1.over_read_ratio == 1.0
    assert m1.ingest_rx_bytes == m0.storage_rx_bytes
    assert m1.storage_rx_bytes <= 0.6 * m0.storage_rx_bytes
    assert m1.cache_rx_bytes > 0
    assert svc.stripe_cache.hit_rate >= 0.5
    c = svc.stripe_cache
    tenants = c.tenants.values()
    for tier in ("dram", "flash"):
        for field in ("bytes_stored", "admitted", "evictions", "hits", "bytes_served"):
            assert sum(getattr(getattr(ts, tier), field) for ts in tenants) == \
                getattr(getattr(c, tier), field), (tier, field)
    assert sum(ts.misses for ts in tenants) == c.misses
    assert set(svc.tenant_summary()) == {"j0", "j1"}
    assert svc.session_errors == {}


def test_session_share_released_on_stop():
    m = PACKAGES["port"]
    wh, t = _table(m, "shr", n_partitions=1, n_sparse=4, seed=2)
    svc = m["service"](wh)
    for name in ("j1", "j2"):   # sequential jobs may each reserve 0.6
        sess = svc.create_session(name, _spec(m, t), n_workers=1, dram_share=0.6,
                                  device="cpu")
        sess.run_to_completion(timeout_s=60)
        assert name not in svc.stripe_cache.tenancy.shares
    import dataclasses

    bad = dataclasses.replace(_spec(m, t), partitions=(0, 99))    # partition 99 missing
    with pytest.raises(KeyError):
        svc.create_session("j3", bad, n_workers=1, dram_share=0.6, device="cpu")
    assert "j3" not in svc.stripe_cache.tenancy.shares
    svc.create_session("j4", _spec(m, t), n_workers=1, dram_share=0.6, device="cpu")
    assert svc.stripe_cache.tenancy.shares["j4"].dram_frac == 0.6


def test_engine_and_device_reach_every_worker(tmp_path):
    m = PACKAGES["port"]
    wh, t = _table(m, "dev")
    svc = TService(wh, tensor_cache=TTensorCache())
    sess = svc.create_session("a", _spec(m, t), n_workers=3, device="cpu")
    numpy_sess = svc.create_session("b", _spec(m, t), n_workers=2, device="cpu",
                                    engine="numpy", decode_engine="numpy")
    for w in sess.workers:
        assert (w.device, w.decode_engine, w.tensor_cache) == ("cpu", "torch", svc.tensor_cache)
        assert isinstance(w.engine, TorchEngine) and str(w.engine.device) == "cpu"
    for w in numpy_sess.workers:
        assert not isinstance(w.engine, TorchEngine) and w.decode_engine == "numpy"
    # the entry points default to the card: no CPU fallback without CUDA
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            svc.create_session("c", _spec(m, t), n_workers=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_run_smoke(str(tmp_path / "trace.json"), rows=256)
        assert not (tmp_path / "trace.json").exists()


# -- the stall report ---------------------------------------------------------


def test_report_equals_reference_on_a_reference_artifact(tmp_path, capsys):
    out = tmp_path / "ref_trace.json"
    results = j_run_smoke(str(out), rows=256)
    assert all(results[t] for t in ("tenant_a", "tenant_b"))
    doc = json.loads(out.read_text())
    assert t_report.build_report(doc) == j_report.build_report(doc)
    assert t_report.check(doc) == j_report.check(doc) == []
    for argv in ([str(out)], [str(out), "--json"], [str(out), "--check"]):
        capsys.readouterr()
        assert j_report.main(argv) == 0
        want = capsys.readouterr()
        assert t_report.main(argv) == 0
        assert capsys.readouterr() == want
    # a broken artifact: both report the same violations
    doc["traceEvents"] = list(reversed(doc["traceEvents"]))
    doc["otherData"] = {"open_spans": 2}
    assert t_report.check(doc) == j_report.check(doc) != []


def test_port_smoke_artifact_passes_the_report_check(tmp_path):
    out = tmp_path / "trace.json"
    results = t_run_smoke(str(out), rows=256, device="cpu")
    assert all(results[t] for t in ("tenant_a", "tenant_b"))
    doc = json.loads(out.read_text())
    assert t_report.check(doc) == []
    rows = t_report.build_report(doc)
    assert {"tenant_a", "tenant_b", "ALL"} <= set(rows)
    assert rows["ALL"]["storage_rx_bytes"] > 0 and rows["ALL"]["over_read"] == 1.0
    assert t_report.main([str(out), "--check"]) == 0


# -- examples/torch -----------------------------------------------------------


def test_quickstart_example_trains_on_the_cpu(capsys):
    main = runpy.run_path(str(ROOT / "examples" / "torch" / "quickstart.py"))["main"]
    assert main(["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    first, last = map(float, re.search(r"loss (\S+) -> (\S+)", text).groups())
    assert "trained 30 steps on cpu" in text and last < first


def test_dsi_characterization_example_prints_the_reference_numbers(capsys):
    ref_main = runpy.run_path(str(ROOT / "examples" / "dsi_characterization.py"))["main"]
    main = runpy.run_path(str(ROOT / "examples" / "torch" / "dsi_characterization.py"))["main"]
    ref_main()
    want = capsys.readouterr().out
    assert main(["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "Table 5" in got and "Table 6" in got and "Fig 7" in got
