"""Does a stalled DPP session re-serve a split whose lease expired?  Both
packages, side by side, under one injected clock (REPRO-C001).

A worker leases a split and stalls on it (no progress, no heartbeat); the
clock passes its lease; the next ``get_split`` reclaims and re-dispatches
the split to another worker; then the first worker's late ``ok`` arrives.
The reference's master accepts the late ``ok`` (it counts the split done,
whoever completed it, and takes the second ``ok`` as a no-op:
``tests/test_dpp.py::test_late_ok_from_expired_lease_is_accepted``), and
nothing stops the worker that holds the re-dispatched lease from
delivering the split again.  So a session above it serves that split's
batches twice.  These tests hold the port to the same: the master's
progress, state and dispatch counts, and the session's batches (how many,
and which rows), equal to the reference's.  Re-serving is the reference's
behaviour, reproduced; ROADMAP Queue 3 records it as a reference fault.
"""
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import dwrf as j_dwrf  # noqa: E402
from repro.core.datagen import DataGenConfig as JDataGenConfig  # noqa: E402
from repro.core.dpp import DPPMaster as JMaster  # noqa: E402
from repro.core.dpp import DPPSession as JSession  # noqa: E402
from repro.core.dpp import SessionSpec as JSpec  # noqa: E402
from repro.core.schema import make_schema as j_make_schema  # noqa: E402
from repro.core.transforms import default_dlrm_pipeline as j_pipeline  # noqa: E402
from repro.core.warehouse import Warehouse as JWarehouse  # noqa: E402
from repro_torch.core import dwrf as t_dwrf  # noqa: E402
from repro_torch.core.datagen import DataGenConfig as TDataGenConfig  # noqa: E402
from repro_torch.core.dpp import DPPMaster as TMaster  # noqa: E402
from repro_torch.core.dpp import DPPSession as TSession  # noqa: E402
from repro_torch.core.dpp import SessionSpec as TSpec  # noqa: E402
from repro_torch.core.schema import make_schema as t_make_schema  # noqa: E402
from repro_torch.core.transforms import default_dlrm_pipeline as t_pipeline  # noqa: E402
from repro_torch.core.warehouse import Warehouse as TWarehouse  # noqa: E402

PACKAGES = {
    "reference": dict(dwrf=j_dwrf, gen=JDataGenConfig, master=JMaster, session=JSession,
                      spec=JSpec, schema=j_make_schema, pipeline=j_pipeline,
                      warehouse=JWarehouse, engines={}),
    "port": dict(dwrf=t_dwrf, gen=TDataGenConfig, master=TMaster, session=TSession,
                 spec=TSpec, schema=t_make_schema, pipeline=t_pipeline,
                 warehouse=TWarehouse, engines={"device": "cpu"}),
}
LEASE_S = 10.0
WAIT_S = 30.0                  # wall-clock bound on each wait for a worker thread


class Clock:
    """The injected clock: time stands still until the test moves it."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def _table_and_spec(pkg, n_partitions=2, rows=512):
    """tests/test_dpp.py's table and spec (256-row stripes and splits,
    batch 256), built from one package's own modules."""
    m = PACKAGES[pkg]
    wh = m["warehouse"]()
    t = wh.create_table(m["schema"]("dpt", 20, 6, seed=0))
    t.generate(n_partitions, m["gen"](rows_per_partition=rows, seed=1),
               m["dwrf"].DwrfWriterOptions(flattened=True, stripe_rows=256))
    dense = t.schema.dense_ids[:6]
    sparse = t.schema.sparse_ids[:3]
    pipe = m["pipeline"](dense, sparse, hash_size=500)
    spec = m["spec"](
        table=t.schema.name, partitions=tuple(t.partitions),
        feature_ids=tuple(pipe.required_features()), transform_specs=tuple(pipe.specs),
        batch_size=256, rows_per_split=256,
        dense_keys=tuple(f"d{f}" for f in dense), sparse_keys=tuple(f"s{f}" for f in sparse),
        max_ids_per_feature=8,
    )
    return t, spec


def _master_run(pkg):
    """The master alone: w0 leases, its lease passes, w1 gets the same
    split, w0's late ok arrives, then w1's."""
    t, spec = _table_and_spec(pkg, n_partitions=1, rows=256)
    clock = Clock()
    m = PACKAGES[pkg]["master"](spec, {p: t.partitions[p].num_rows for p in spec.partitions},
                                lease_s=LEASE_S, dispatch_budget=3, clock=clock)
    s = m.get_split("w0")
    clock.now += LEASE_S + 1
    s2 = m.get_split("w1")
    steps = [("redispatched", s2 is not None and s2.split_id == s.split_id)]
    m.complete_split("w0", s.split_id)         # the late ok from the expired lease
    steps.append(("after late ok", (m.progress, m.finished, m.state, dict(m.quarantined))))
    m.complete_split("w1", s2.split_id)        # the current holder's ok
    steps.append(("after holder's ok", (m.progress, m.finished, m.state)))
    steps.append(("dispatches", m.checkpoint()["dispatches"]))
    return steps


def test_master_accepts_a_late_ok_and_counts_the_split_once_in_both_packages():
    ref, port = _master_run("reference"), _master_run("port")
    assert ref == port
    steps = dict(ref)
    assert steps["redispatched"]
    assert steps["after late ok"][:2] == ((1, 1), True)
    assert steps["dispatches"] == {0: 2}


def _wait(cond, what):
    deadline = time.perf_counter() + WAIT_S
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _session_run(pkg):
    """A 2-worker session over 4 splits (4 batches).  w0 stalls inside
    its first split; the clock passes its lease; w1 reclaims the split
    and is held before processing it until w0's late ok (after w0 has
    delivered its batches) has arrived; then both deliver.  The client
    drains every batch before the session stops.  Returns the batches'
    first labels and rows, the dispatch counts and the master's state."""
    t, spec = _table_and_spec(pkg)
    clock = Clock()
    sess = PACKAGES[pkg]["session"](spec, t, n_workers=2, lease_s=LEASE_S, clock=clock,
                                    monitor_interval_s=0.01, **PACKAGES[pkg]["engines"])
    w0, w1 = sess.workers
    stalled, release, late_ok = threading.Event(), threading.Event(), threading.Event()
    held = {}
    oks = []

    def stall(process):
        def run(reader, split):
            if not stalled.is_set():
                held["split"] = split.split_id
                stalled.set()
                release.wait(WAIT_S)              # no progress, no heartbeat
            return process(reader, split)
        return run

    def hold_redispatch(process):
        def run(reader, split):
            if split.split_id == held.get("split"):
                late_ok.wait(WAIT_S)              # w0's late ok comes first
            return process(reader, split)
        return run

    complete = sess.master.complete_split

    def record(worker_id, split_id, **kw):
        oks.append((worker_id, split_id, kw.get("status", "ok")))
        complete(worker_id, split_id, **kw)
        if worker_id == "w0" and split_id == held.get("split"):
            late_ok.set()

    w0.process_split = stall(w0.process_split)
    w1.process_split = hold_redispatch(w1.process_split)
    sess.master.complete_split = record
    batches = []
    sess.start()
    try:
        _wait(stalled.is_set, "w0 to lease and stall")
        sid = held["split"]
        clock.now += LEASE_S + 1                  # past w0's lease
        _wait(lambda: sess.master.checkpoint()["dispatches"].get(sid, 0) == 2,
              "the split's re-dispatch")
        release.set()

        def drained():
            b = sess.clients[0].get_batch(timeout=0.05)
            if b is not None:
                batches.append(b)
            return (sess.master.finished and sum(1 for o in oks if o[1] == sid) == 2
                    and all(w.buffered == 0 for w in sess.workers))
        _wait(drained, "every split's ok and every batch")
    finally:
        release.set()
        late_ok.set()
        sess.stop()
    first = sorted((int(b["label"].shape[0]), np.asarray(b["dense"])[0].round(5).tolist())
                   for b in batches)
    return {"batches": len(batches), "rows": sum(int(b["label"].shape[0]) for b in batches),
            "first_rows": first, "dispatches": sess.master.checkpoint()["dispatches"],
            "progress": sess.master.progress, "state": sess.master.state,
            "oks": sorted(o for o in oks if o[1] == sid)}


def test_stalled_session_reserves_the_expired_split_in_both_packages():
    """Both packages serve 5 batches for 4 splits: the stalled split's
    batch twice, its rows identical; the split dispatched twice, both
    ok's accepted, the epoch counted complete once."""
    ref, port = _session_run("reference"), _session_run("port")
    assert ref == port
    assert ref["batches"] == 5 and ref["rows"] == 5 * 256
    assert ref["progress"] == (4, 4)
    assert sorted(ref["dispatches"].values()) == [1, 1, 1, 2]
    rows = [r for _, r in ref["first_rows"]]
    assert len({tuple(r) for r in rows}) == 4     # one batch served twice
    assert [w for w, _, _ in ref["oks"]] == ["w0", "w1"]
