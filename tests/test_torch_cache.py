"""The port's shared stripe-cache tier, tensor cache and prefetch planner
against the reference's (``repro.core.cache``, ``repro.core.dpp``).

These modules are numpy-only copies, so every comparison here is exact:
the same calls on the same inputs, driven through both packages side by
side, give equal return values, keys, segments and statistics.  The
single-flight, rewrite-under-inflight-read and generation tests mirror
``tests/test_cache.py``'s on the port's classes.  Every test runs under the
lock-order sanitizer (the ``lockdep`` marker), whose lock-site filter
matches the port's files by name as it does the reference's.
"""
import threading

import numpy as np
import pytest

pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro.core import cache as j_cache  # noqa: E402
from repro.core import dwrf as j_dwrf  # noqa: E402
from repro.core.datagen import DataGenConfig as JDataGenConfig  # noqa: E402
from repro.core.datagen import generate_partition as j_generate  # noqa: E402
from repro.core.dpp import DPPMaster as JMaster  # noqa: E402
from repro.core.dpp import PrefetchPlanner as JPlanner  # noqa: E402
from repro.core.dpp import SessionSpec as JSpec  # noqa: E402
from repro.core.dpp import tensor_cache as j_tc  # noqa: E402
from repro.core.schema import make_schema as j_make_schema  # noqa: E402
from repro.core.transforms import default_dlrm_pipeline as j_pipeline  # noqa: E402
from repro.core.warehouse import Warehouse as JWarehouse  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import dwrf as t_dwrf  # noqa: E402
from repro_torch.core.datagen import DataGenConfig as TDataGenConfig  # noqa: E402
from repro_torch.core.datagen import generate_partition as t_generate  # noqa: E402
from repro_torch.core.dpp import DPPMaster as TMaster  # noqa: E402
from repro_torch.core.dpp import PrefetchPlanner as TPlanner  # noqa: E402
from repro_torch.core.dpp import SessionSpec as TSpec  # noqa: E402
from repro_torch.core.dpp import tensor_cache as t_tc  # noqa: E402
from repro_torch.core.reader import TableReader as TReader  # noqa: E402
from repro_torch.core.schema import make_schema as t_make_schema  # noqa: E402
from repro_torch.core.tectonic import TectonicFS as TFS  # noqa: E402
from repro_torch.core.transforms import default_dlrm_pipeline as t_pipeline  # noqa: E402
from repro_torch.core.warehouse import Warehouse as TWarehouse  # noqa: E402

pytestmark = pytest.mark.lockdep

PACKAGES = {
    "reference": dict(cache=j_cache, dwrf=j_dwrf, gen=JDataGenConfig, generate=j_generate,
                      master=JMaster,
                      planner=JPlanner, spec=JSpec, tc=j_tc, schema=j_make_schema,
                      pipeline=j_pipeline, warehouse=JWarehouse),
    "port": dict(cache=t_cache, dwrf=t_dwrf, gen=TDataGenConfig, generate=t_generate,
                 master=TMaster,
                 planner=TPlanner, spec=TSpec, tc=t_tc, schema=t_make_schema,
                 pipeline=t_pipeline, warehouse=TWarehouse),
}
ROWS = 512
STRIPE = 128


def _both(fn):
    """``fn(package dict)`` for the reference and the port."""
    return fn(PACKAGES["reference"]), fn(PACKAGES["port"])


def _table(m, n_partitions=2, rows=ROWS, stripe=STRIPE, name="ct", seed=3, n_dense=16,
           n_sparse=6):
    wh = m["warehouse"]()
    t = wh.create_table(m["schema"](name, n_dense, n_sparse, seed=seed))
    t.generate(n_partitions, m["gen"](rows_per_partition=rows, seed=4 if seed == 3 else 1),
               m["dwrf"].DwrfWriterOptions(flattened=True, stripe_rows=stripe))
    return wh, t


def _spec(m, t, n_dense=6, n_sparse=3, batch_size=256, rows_per_split=256, **kw):
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


# -- dedup and tenancy: equal to the reference ------------------------------


def test_stripe_digest_and_dedup_index_equal_reference():
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (0, 1, 300, 4096)]
    payloads.append(payloads[2])                       # a byte-identical stripe

    def run(m):
        c = m["cache"]
        out = [c.stripe_digest(p) for p in payloads]
        d = c.DedupIndex()
        off = 0
        for path in ("f", "g"):
            off = 0
            for p in payloads:
                out.append(d.register(path, off, len(p), p))
                off += len(p)
        out.append(d.register("f", 0, 1, b"x"))          # idempotent on (path, offset)
        for path, o, ln in (("f", 1, 300), ("f", 10, 50), ("f", 290, 20), ("f", 0, off),
                            ("g", 301, 4096), ("h", 0, 10)):
            out.append(d.resolve(path, o, ln))
            out.append(d.segments(path, o, ln))
        d.invalidate("f")
        out += [d.generation("f"), d.generation("g"), d.resolve("f", 1, 300),
                d.segments("f", 0, 100), d.unique_stripes,
                (d.stats.stripes_registered, d.stats.logical_bytes, d.stats.unique_bytes,
                 d.stats.dedup_ratio)]
        return out

    ref, port = _both(run)
    assert port == ref


def test_tenant_policy_accepts_and_refuses_the_same_shares():
    steps = [("set", "a", 0.7, 0.0), ("set", "b", 0.5, 0.0), ("set", "b", 0.3, 0.0),
             ("set", "a", 0.6, 0.2), ("set", "c", 0.0, 0.9), ("clear", "a"),
             ("set", "c", 0.7, 0.8), ("set", "d", 0.0, 0.3), ("set", "d", 0.0, 0.2)]

    def run(m):
        c = m["cache"]
        pol = c.TenantPolicy()
        out = []
        for st in steps:
            if st[0] == "clear":
                pol.clear_share(st[1])
                out.append("cleared")
                continue
            try:
                s = pol.set_share(st[1], st[2], st[3])
                out.append(("ok", s.dram_frac, s.flash_frac))
            except ValueError as e:
                out.append(("refused", str(e)))
        out.append({t: (s.dram_frac, s.flash_frac) for t, s in pol.shares.items()})
        out.append([pol.guaranteed_bytes(t, tier, 1000)
                    for t in ("a", "b", "c", "d", None) for tier in ("dram", "flash")])
        try:       # the constructor validates too
            c.TenantPolicy({"a": c.TenantShare(0.9), "b": c.TenantShare(0.9)})
            out.append("built")
        except ValueError as e:
            out.append(("refused", str(e)))
        return out

    ref, port = _both(run)
    assert port == ref
    assert ("refused", "dram shares would sum to 1.200 > 1.0 adding tenant 'b'") in port


# -- StripeCache: one scripted sequence through both caches -----------------


class Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _cache_script(m):
    """DRAM and flash tiers, popularity-gated flash admission, TTL expiry,
    sub-range and content-dedup hits, single-flight claims and aborts,
    path invalidation, and tenant shares with borrow-when-idle, driven in
    one fixed order under one injected clock.  Returns every call's result
    and the final accounting."""
    c = m["cache"]
    clock = Clock()
    cache = c.StripeCache(
        dram_capacity_bytes=1000, flash_capacity_bytes=1500, flash_admit_reads=2,
        tenancy=c.TenantPolicy({"vip": c.TenantShare(0.4, 0.3)}), ttl_s=50.0, clock=clock,
    )
    stripes = [bytes([65 + i]) * 300 for i in range(3)]
    for path in ("f", "g"):                  # g is a byte-identical copy of f
        for i, s in enumerate(stripes):
            cache.dedup.register(path, 300 * i, 300, s)
    log = []

    def look(r):
        return None if r is None else (r.payload, r.tier)

    def claim(path, off, ln, tenant, payload=None):
        key = cache.resolve(path, off, ln)
        r = cache.get_or_claim(key, timeout_s=1.0, tenant=tenant)
        log.append(("claim", path, off, ln, tenant, look(r)))
        if r is None:
            if payload is None:
                cache.abort(key)
            else:
                cache.admit(key, payload, tenant=tenant)
        return r

    # vip fills stripes 0 and 1 of f (600 B, over its 400 B guarantee) and
    # re-reads stripe 0 twice (popular); b hits stripe 0 through path g
    claim("f", 0, 300, "vip", stripes[0])
    claim("f", 300, 300, "vip", stripes[1])
    for _ in range(2):
        claim("f", 0, 300, "vip")
    claim("f", 10, 50, "vip")                # a sub-range of a cached stripe
    claim("g", 0, 300, "b")                  # content dedup across paths
    claim("g", 600, 300, "b", None)          # a claim aborted by a failed read
    log.append(("get", look(cache.get(cache.resolve("g", 600, 300), tenant="b"))))
    clock.now += 1.0
    # a scanning tenant streams one-touch path-addressed extents through DRAM:
    # victims come from tenants over their guarantee, popular ones go to flash
    for i in range(12):
        claim(f"scan{i}", 0, 100, "scan", bytes([i]) * 100)
        if i % 3 == 0:
            claim(f"scan{i}", 0, 100, "scan")    # read twice: popular
        clock.now += 1.0
    for path, off in (("f", 0), ("f", 300), ("scan0", 0), ("scan3", 0), ("scan1", 0)):
        key = cache.resolve(path, off, 300 if path == "f" else 100)
        log.append(("peek", path, cache.peek(key)))
        log.append(("get", path, look(cache.get(key, tenant="vip"))))   # flash hits promote
    # an unregistered path is path-addressed; a rewrite invalidates it
    claim("h", 0, 64, "b", b"h" * 64)
    cache.invalidate_path("h")
    log.append(("after invalidate", look(cache.get(cache.resolve("h", 0, 64), tenant="b"))))
    cache.admit(("p", ("h", 0), 0, 64), b"o" * 64, tenant="b")     # a stale late admit
    log.append(("stale admit", look(cache.get(cache.resolve("h", 0, 64), tenant="b"))))
    # TTL: everything admitted before now - 50 s has expired
    clock.now += 45.0
    claim("f", 0, 300, "vip", stripes[0])
    clock.now += 10.0
    for path, off, ln in (("f", 0, 300), ("scan11", 0, 100), ("scan9", 0, 100)):
        log.append(("ttl", path, cache.peek(cache.resolve(path, off, ln)),
                    look(cache.get(cache.resolve(path, off, ln), tenant="scan"))))
    # the vip's share lapses: a lone tenant may fill the whole tier
    cache.tenancy.clear_share("vip")
    for i in range(9):
        claim(f"lone{i}", 0, 100, "lone", bytes([200 + i]) * 100)
    log.append(("ios", cache.tier_iops_per_watt(),
                {t: (s.dram.io.num_ios, s.flash.io.num_ios) for t, s in cache.tenants.items()},
                cache.dram.io.io_sizes, cache.flash.io.io_sizes))
    return log, cache.summary(), cache.tenant_summary()


def test_stripe_cache_scripted_sequence_equals_reference():
    (ref_log, ref_sum, ref_ten), (log, summary, tenants) = _both(_cache_script)
    assert log == ref_log
    assert summary == ref_sum
    assert tenants == ref_ten
    # the script reached every part it claims to cover
    assert summary["dram_hits"] > 0 and summary["flash_hits"] > 0
    assert summary["expired"] > 0 and summary["dedup_ratio"] == 2.0
    assert tenants["vip"]["dram_evictions"] > 0 and tenants["scan"]["dram_evictions"] > 0
    assert tenants["lone"]["dram_bytes_stored"] > 400


def test_single_flight_coalesces_concurrent_misses():
    cache = t_cache.StripeCache()
    key = ("p", "f", 0, 4)
    claims, hits = [], []
    started = threading.Event()

    def first():
        got = cache.get_or_claim(key)
        assert got is None          # cold: this thread owns the fill
        claims.append(1)
        started.set()
        cache.admit(key, b"data")   # releases the waiting reader

    def second():
        started.wait(5)
        hits.append(cache.get_or_claim(key).payload)   # blocks for the fill

    t2 = threading.Thread(target=second)
    t2.start()
    first()
    t2.join(5)
    assert claims == [1] and hits == [b"data"]
    assert cache.misses == 1 and cache.dram.hits == 1


def test_generation_prevents_stale_admit_after_rewrite():
    cache = t_cache.StripeCache()
    key_old = cache.resolve("f", 0, 4)
    cache.invalidate_path("f")            # the rewrite lands mid-read
    cache.admit(key_old, b"OLD!")         # stale late admit
    key_new = cache.resolve("f", 0, 4)
    assert key_new != key_old
    assert cache.get(key_new) is None     # old bytes unreachable


def _assert_batches_identical(a, b):
    assert a.num_rows == b.num_rows
    assert set(a.dense) == set(b.dense) and set(a.sparse) == set(b.sparse)
    for fid in a.dense:
        np.testing.assert_array_equal(np.nan_to_num(a.dense[fid]), np.nan_to_num(b.dense[fid]))
    for fid in a.sparse:
        np.testing.assert_array_equal(a.sparse[fid].offsets, b.sparse[fid].offsets)
        np.testing.assert_array_equal(a.sparse[fid].values, b.sparse[fid].values)
    np.testing.assert_array_equal(a.labels, b.labels)


def test_rewrite_racing_inflight_read_never_poisons_cache():
    # a rewrite landing inside read_extents_ex (after the reader's
    # (data, generation) snapshot) must not let the in-flight reader admit
    # its pre-rewrite bytes under keys that describe the new file version
    m = PACKAGES["port"]
    wh, t = _table(m)
    cache = t_cache.StripeCache()
    wh.attach_cache(cache)
    proj = t.schema.logged_ids[:8]
    opts = t_dwrf.DwrfWriterOptions(flattened=True, stripe_rows=STRIPE)
    new_batch = t_generate(t.schema, 0, TDataGenConfig(rows_per_partition=ROWS, seed=77))
    r = TReader(t, proj, record_popularity=False)
    old_meta = t.partitions[0]
    orig_segments = cache.dedup.segments
    fired = []

    def seg_hook(path, off, ln):
        if not fired and path == old_meta.path:
            fired.append(1)
            t.rewrite_partition(0, new_batch, opts)   # lands mid-read
        return orig_segments(path, off, ln)

    cache.dedup.segments = seg_hook
    try:
        sr = next(iter(r.iter_stripes(old_meta, 0, STRIPE)))
    finally:
        cache.dedup.segments = orig_segments
    assert fired
    assert sr.bytes_from_storage == sr.bytes_read   # old bytes, not cache

    wh2 = TWarehouse()
    t2 = wh2.create_table(t.schema)
    t2.write_partition(0, new_batch, opts)
    ref = TReader(t2, proj, record_popularity=False).read_rows(t2.partitions[0], 0, ROWS)
    post = r.read_rows(t.partitions[0], 0, ROWS)
    _assert_batches_identical(post.batch, ref.batch)   # never the old bytes
    again = r.read_rows(t.partitions[0], 0, ROWS)
    assert again.bytes_from_cache == again.bytes_read
    _assert_batches_identical(again.batch, ref.batch)


def test_inflight_read_admit_checks_generation():
    fs = TFS()
    cache = t_cache.StripeCache()
    fs.attach_cache(cache)
    old, new = b"A" * 100, b"B" * 100
    fs.create("f", old)
    cache.dedup.register("f", 0, 100, old)
    orig_segments = cache.dedup.segments
    fired = []

    def seg_hook(path, off, ln):
        out = orig_segments(path, off, ln)
        if not fired:
            fired.append(1)
            fs.rewrite("f", new)                     # invalidates + bumps gen
            cache.dedup.register("f", 0, 100, new)   # same span geometry
        return out

    cache.dedup.segments = seg_hook
    try:
        racing = fs.read_extents_ex("f", [(0, 100)])
    finally:
        cache.dedup.segments = orig_segments
    assert racing.blobs == [old]          # the pre-rewrite reader gets old bytes
    assert fs.read_all("f") == new        # but nobody after it ever does
    assert fs.read_all("f") == new        # (and the cached copy is the new one)


# -- TensorCache: equal to the reference ------------------------------------


def test_pipeline_fingerprint_and_key_equal_reference():
    """The fingerprint hashes the reprs of the spec's feature ids and
    transform specs; the port's ``TransformSpec`` and params print as the
    reference's, so the fingerprints (and the cache keys) are equal."""
    def run(m):
        out = []
        for hash_size in (100, 200):
            p = m["pipeline"]([0, 3], [10, 11], hash_size=hash_size)
            spec = m["spec"](table="x", partitions=(0,), feature_ids=tuple(p.required_features()),
                             transform_specs=tuple(p.specs), dense_keys=("d0", "d3"),
                             sparse_keys=("s10", "s11"), rows_per_split=256)
            out.append(m["tc"].pipeline_fingerprint(spec))
            master = m["master"](spec, {0: 1024}, partition_stripe_rows={0: 256})
            out += [m["tc"].TensorCache.key(spec, split, generation=2)
                    for split in master.peek_pending(8)]
        return out

    ref, port = _both(run)
    assert port == ref
    assert port[0] != port[5]           # a pipeline change changes the key
    assert len(set(port)) == len(port)


def test_tensor_cache_lru_rejection_and_refresh_equal_reference():
    def run(m):
        tc = m["tc"].TensorCache(capacity_bytes=3000)
        mk = lambda v, n=250: [{"x": np.full(n, v, np.float32)}]   # noqa: E731
        out = []
        tc.put(("a",), mk(1.0), cpu_s=0.1)
        tc.put(("b",), mk(2.0), cpu_s=0.2)
        tc.put(("c",), mk(3.0), cpu_s=0.3)
        tc.put(("a",), mk(99.0), cpu_s=0.1)      # insert hit: first entry wins, recency refreshed
        out.append(float(tc.get(("a",))[0]["x"][0]))
        tc.put(("d",), mk(4.0), cpu_s=0.4)       # evicts b, the LRU entry
        tc.put(("big",), mk(5.0, 1000), cpu_s=0.5)   # 4000 B > capacity: refused
        for k in ("a", "b", "c", "d", "big"):
            got = tc.get((k,))
            out.append(None if got is None else float(got[0]["x"][0]))
        s = tc.stats
        out.append((s.hits, s.misses, s.bytes_stored, s.cpu_s_saved, s.evictions, s.rejected,
                    s.hit_rate))
        return out

    ref, port = _both(run)
    assert port == ref
    assert port[0] == 1.0 and port[2] is None and port[-2] is None


def test_tensor_cache_generation_aware_keys_after_rewrite():
    from repro_torch.core.dpp import DPPSession

    m = PACKAGES["port"]
    _, t = _table(m, n_partitions=1, rows=512, stripe=256, name="dpt", seed=0,
                  n_dense=20)
    spec = _spec(m, t, partitions=(0,))
    cache = t_tc.TensorCache()

    def epoch():
        sess = DPPSession(spec, t, n_workers=1, tensor_cache=cache, device="cpu")
        return sess.run_to_completion(timeout_s=60), sess.worker_metrics()

    first, m1 = epoch()
    warm, m2 = epoch()
    assert (m1.rows_from_cache, m2.rows_from_cache) == (0, 512)
    t.rewrite_partition(
        0, t_generate(t.schema, 0, TDataGenConfig(rows_per_partition=512, seed=99)),
        t_dwrf.DwrfWriterOptions(flattened=True, stripe_rows=256),
    )
    assert t.partitions[0].generation == 1
    post, m3 = epoch()
    assert m3.rows_from_cache == 0            # new generation: no stale serve
    assert (sorted(float(np.nan_to_num(b["dense"]).sum()) for b in post)
            != sorted(float(np.nan_to_num(b["dense"]).sum()) for b in warm))


# -- PrefetchPlanner: the same plan and fills as the reference --------------


def test_prefetch_planner_plans_and_fills_equal_reference():
    """``tests/test_dpp.py``'s planner test, both packages on the same
    master state: the same uncached segments planned, the same bytes
    fetched, then nothing left to fetch, then (after a rewrite) the
    rewritten partition's splits warmed again."""
    def run(m):
        wh, t = _table(m, n_partitions=2, rows=1024, stripe=256, name="pf", seed=0,
                       n_dense=20)
        cache = m["cache"].StripeCache()
        wh.attach_cache(cache)
        spec = _spec(m, t)
        rows = {p: t.partitions[p].num_rows for p in spec.partitions}
        master = m["master"](spec, rows,
                             partition_stripe_rows={p: 256 for p in spec.partitions})
        planner = m["planner"](t, master, spec.feature_ids, tenant="job", depth=32)
        segments = [planner._uncached_extents(s) for s in master.peek_pending(32)]
        planner = m["planner"](t, master, spec.feature_ids, tenant="job", depth=32)
        out = [segments, planner.prefetch_once()]
        planner2 = m["planner"](t, master, spec.feature_ids, tenant="job", depth=32)
        out.append(planner2.prefetch_once())
        for p in (planner, planner2):
            pm = p.metrics
            out.append((pm.plans, pm.splits_warmed, pm.bytes_fetched,
                        pm.bytes_already_cached, pm.pokes))
        out.append(cache.tenant_summary())
        t.rewrite_partition(
            0, m["generate"](t.schema, 0, m["gen"](rows_per_partition=1024, seed=9)),
            m["dwrf"].DwrfWriterOptions(flattened=True, stripe_rows=256),
        )
        out.append(planner2.prefetch_once())
        out.append(planner2.metrics.splits_warmed)
        return out

    ref, port = _both(run)
    assert port == ref
    segments, fetched, again = port[:3]
    assert fetched > 0 and again == 0
    assert sum(ln for _, segs in segments for _, ln in segs) == fetched
    assert port[-2] > 0
