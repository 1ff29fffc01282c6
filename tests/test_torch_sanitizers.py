"""The port's runtime sanitizers (``repro_torch.analysis``: ``lockdep``,
``racedep`` and ``sched``) against the reference's.

  * the scripted thread programs of ``tests/test_lockdep.py`` and
    ``tests/test_racedep.py`` run once under each package's detectors and
    give the same cycle and race verdicts, with the same lock names;
  * the reference's raced session and cache-traffic tests run on the
    port's classes (``device="cpu"``) under the port's detectors;
  * the seeded explorer scenarios of ``tests/test_sched.py`` and the
    gate's four control-plane scenarios give equal (schedules, pruned,
    exhausted) in both packages, the port's scenarios on ``device="cpu"``;
  * no silent CPU: the port's explorer without ``--device cpu`` fails on a
    machine without a card.
"""
from __future__ import annotations

import os
import queue
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro.analysis import lockdep as ref_ld  # noqa: E402
from repro.analysis import racedep as ref_rd  # noqa: E402
from repro.analysis import sched as ref_sc  # noqa: E402
from repro_torch.analysis import lockdep as ld  # noqa: E402
from repro_torch.analysis import racedep as rd  # noqa: E402
from repro_torch.analysis import sched as sc  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SIDES = {"ref": (ref_ld, ref_rd, ref_sc), "port": (ld, rd, sc)}

# lock construction sites the sanitizers track: repo modules only (the
# file set of the reference's lockdep fixture)
REPO_LOCK_FILES = sc._REPO_LOCK_FILES + ("embedding_cache.py",)


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()


# -- lockdep: the scripted programs of tests/test_lockdep.py -------------------


def _nest(graph, *names):
    for n in names:
        graph.note_acquire(n)
    for n in reversed(names):
        graph.note_release(n)


def _graph_program(orders, ignore=()):
    def run(lockdep):
        g = lockdep.LockGraph(ignore=ignore)
        for names in orders:
            _nest(g, *names)
        return g
    return run


def _seeded_inversion(lockdep):
    with lockdep.patched() as g:
        a = threading.Lock()
        b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return g


def _consistent_nesting(lockdep):
    with lockdep.patched() as g:
        outer = threading.Lock()
        inner = threading.Lock()
    for _ in range(2):
        with outer:
            with inner:
                pass
    return g


def _rlock_reentry(lockdep):
    with lockdep.patched() as g:
        r = threading.RLock()
    with r:
        with r:
            pass
    return g


def _filtered_out(lockdep):
    with lockdep.patched(name_filter=lambda s: False) as g:
        a = threading.Lock()
        b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return g


def _condition_wait(lockdep):
    with lockdep.patched() as g:
        lk = threading.Lock()
        cond = threading.Condition(lk)
    hits = []

    def worker():
        with cond:
            while not hits:
                cond.wait(timeout=5.0)
            hits.append("seen")

    t = threading.Thread(target=worker)
    t.start()
    with cond:
        hits.append("set")
        cond.notify_all()
    t.join(timeout=5.0)
    assert not t.is_alive() and hits == ["set", "seen"]
    return g


def _cross_thread_inversion(lockdep):
    with lockdep.patched() as g:
        a = threading.Lock()
        b = threading.Lock()

    def t1():
        with a:
            with b:
                pass

    _in_thread(t1)
    with b:
        with a:
            pass
    return g


LOCK_PROGRAMS = {
    # name: (program, whether it must report a cycle)
    "two_lock_inversion": (_graph_program([("A", "B"), ("B", "A")]), True),
    "three_lock_cycle": (_graph_program([("A", "B"), ("B", "C"), ("C", "A")]), True),
    "consistent_order": (_graph_program([("A", "B", "C")] * 3 + [("A", "C")]), False),
    "ignore_suppresses_ladder": (_graph_program([("A", "B"), ("B", "A")], ignore=["B"]),
                                 False),
    "reentrant_reacquire": (_graph_program([("R", "R")]), False),
    "seeded_inversion_under_patch": (_seeded_inversion, True),
    "consistent_nesting_under_patch": (_consistent_nesting, False),
    "patched_rlock_reentry": (_rlock_reentry, False),
    "name_filter_limits_tracking": (_filtered_out, False),
    "condition_and_threads": (_condition_wait, False),
    "cross_thread_inversion": (_cross_thread_inversion, True),
}


def _cycle_verdict(g):
    nodes = g.nodes() if hasattr(g, "nodes") else sorted(g._nodes)  # the port's counter
    return (sorted(tuple(sorted(c[:-1])) for c in g.cycles()), g.edges(), nodes)


@pytest.mark.parametrize("name", sorted(LOCK_PROGRAMS))
def test_lockdep_verdicts_equal_the_reference(name):
    program, must_cycle = LOCK_PROGRAMS[name]
    verdicts = {}
    for side, (lockdep, _rd, _sc) in SIDES.items():
        g = program(lockdep)
        verdicts[side] = _cycle_verdict(g)
        if must_cycle:
            with pytest.raises(lockdep.LockOrderError) as ei:
                g.assert_no_cycles()
            assert "lock-order cycle" in str(ei.value)
        else:
            g.assert_no_cycles()
    assert verdicts["port"] == verdicts["ref"]
    assert bool(verdicts["ref"][0]) == must_cycle


def test_lockdep_restores_real_factories():
    real_lock, real_rlock = threading.Lock, threading.RLock
    with ld.patched():
        assert threading.Lock is not real_lock
    assert threading.Lock is real_lock and threading.RLock is real_rlock


# -- racedep: the scripted programs of tests/test_racedep.py -------------------


class Racy:
    def __init__(self):
        self.x = 0


class Guarded:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump(self):
        with self._lock:
            self.n += 1

    def read(self):
        with self._lock:
            return self.n


class SplitBrain:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()
        self.v = 0

    def via_a(self):
        with self._a_lock:
            self.v += 1

    def via_b(self):
        with self._b_lock:
            self.v += 1


class HalfGuarded:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump(self):
        with self._lock:
            self.n += 1


class Allowlisted:
    _unshared = ("flag",)

    def __init__(self):
        self.flag = False


def _unlocked_write():
    obj = Racy()
    _in_thread(lambda: setattr(obj, "x", 1))
    obj.x = 2


def _disjoint_locksets():
    obj = SplitBrain()
    _in_thread(obj.via_a)
    obj.via_b()
    _in_thread(obj.via_a)


def _unlocked_read_of_written():
    obj = HalfGuarded()
    _in_thread(obj.bump)
    _ = obj.n
    _in_thread(obj.bump)


def _common_lock():
    obj = Guarded()
    _in_thread(obj.bump)
    obj.bump()
    assert obj.read() == 2


def _allowlisted():
    obj = Allowlisted()
    _in_thread(lambda: setattr(obj, "flag", True))
    assert obj.flag is True


def _init_publication():
    obj = Racy()
    _in_thread(lambda: obj.x)
    _ = obj.x


def _thread_handoff():
    obj = Racy()

    def worker():
        obj.x = 1
        obj.x = 2

    _in_thread(worker)


RACE_PROGRAMS = {
    # name: (classes, body, the (class, attribute) races it must report)
    "unlocked_write": ([Racy], _unlocked_write, [("Racy", "x")]),
    "disjoint_locksets": ([SplitBrain], _disjoint_locksets, [("SplitBrain", "v")]),
    "unlocked_read_of_written": ([HalfGuarded], _unlocked_read_of_written,
                                 [("HalfGuarded", "n")]),
    "common_lock": ([Guarded], _common_lock, []),
    "unshared_allowlist": ([Allowlisted], _allowlisted, []),
    "init_publication": ([Racy], _init_publication, []),
    "thread_handoff": ([Racy], _thread_handoff, []),
}


def _race_verdict(det):
    if hasattr(det, "observed"):          # the port's counter
        observed = det.observed()
    else:
        observed = (len(det._state), sum(st.lockset is not None
                                         for st in det._state.values()))
    return observed, [(r.cls, r.attr, r.instances, r.sharing.locks, r.write.locks)
                      for r in det.races()]


@pytest.mark.parametrize("name", sorted(RACE_PROGRAMS))
def test_racedep_verdicts_equal_the_reference(name):
    classes, body, races = RACE_PROGRAMS[name]
    verdicts = {}
    for side, (lockdep, racedep, _sc) in SIDES.items():
        with lockdep.patched(name_filter=lambda s: True) as graph:
            with racedep.instrument(graph, classes=classes) as det:
                body()
        verdicts[side] = _race_verdict(det)
        if races:
            with pytest.raises(racedep.RaceError) as ei:
                det.assert_no_races()
            assert "REPRO-R001" in str(ei.value)
        else:
            det.assert_no_races()
    assert verdicts["port"] == verdicts["ref"]
    assert [v[:2] for v in verdicts["ref"][1]] == races
    assert verdicts["ref"][0][1] >= len(races)      # a race needs a shared pair


def test_racedep_restores_class_protocol():
    get0, set0 = Racy.__getattribute__, Racy.__setattr__
    with ld.patched(name_filter=lambda s: True) as graph:
        with rd.instrument(graph, classes=[Racy]):
            assert Racy.__getattribute__ is not get0
    assert Racy.__getattribute__ is get0 and Racy.__setattr__ is set0
    assert "__getattribute__" not in Racy.__dict__ and "__init__" in Racy.__dict__


# -- the port's classes under both detectors (the reference's raced tests) -----


@pytest.fixture
def raced():
    """The port's lockset race detector and lock-order sanitizer over its
    core threaded classes; teardown fails on a race or a cycle."""
    with ld.patched(name_filter=lambda s: s.startswith(REPO_LOCK_FILES)) as graph:
        with rd.instrument(graph) as det:
            yield det
    det.assert_no_races()
    graph.assert_no_cycles()


def _tiny_table():
    from repro_torch.core import dwrf
    from repro_torch.core.datagen import DataGenConfig
    from repro_torch.core.schema import make_schema
    from repro_torch.core.warehouse import Warehouse

    s = make_schema("rt", 8, 3, seed=0)
    t = Warehouse().create_table(s)
    t.generate(1, DataGenConfig(rows_per_partition=256, seed=1),
               dwrf.DwrfWriterOptions(flattened=True, stripe_rows=128))
    return t


def test_session_run_is_race_free(raced):
    """A 2-worker port session on the CPU, end to end, under both detectors:
    zero races and zero cycles (teardown), every row served."""
    from repro_torch.core.dpp import DPPSession, SessionSpec
    from repro_torch.core.transforms import default_dlrm_pipeline

    t = _tiny_table()
    dense = t.schema.dense_ids[:3]
    sparse = t.schema.sparse_ids[:2]
    pipe = default_dlrm_pipeline(dense, sparse, hash_size=64)
    spec = SessionSpec(
        table=t.schema.name, partitions=tuple(t.partitions),
        feature_ids=tuple(pipe.required_features()),
        transform_specs=tuple(pipe.specs),
        batch_size=64, rows_per_split=128,
        dense_keys=tuple(f"d{f}" for f in dense),
        sparse_keys=tuple(f"s{f}" for f in sparse),
        max_ids_per_feature=4,
    )
    sess = DPPSession(spec, t, n_workers=2, device="cpu")
    batches = sess.run_to_completion(timeout_s=60)
    assert sess.state == "COMPLETED"
    assert sum(len(b["label"]) for b in batches) == 256
    assert len(raced.races()) == 0


def test_cache_cross_thread_traffic_is_race_free(raced):
    from repro_torch.core.cache import StripeCache
    from repro_torch.core.dpp.master import SessionSpec, Split
    from repro_torch.core.dpp.tensor_cache import TensorCache

    cache = StripeCache(dram_capacity_bytes=1 << 20)
    tc = TensorCache(capacity_bytes=1 << 20)
    spec = SessionSpec(table="t", partitions=(0,), feature_ids=(0,),
                       transform_specs=(), rows_per_split=64)
    split = Split(split_id=0, partition=0, row_start=0, row_end=64)
    key = TensorCache.key(spec, split, 0)
    payload = b"z" * 64

    def worker():
        k = cache.resolve("/p", 0, 64)
        cache.admit(k, payload, tenant="a")
        tc.put(key, [{"d": np.zeros(4, dtype=np.float32)}], cpu_s=0.01)

    _in_thread(worker)
    k = cache.resolve("/p", 0, 64)
    assert cache.peek(k)
    assert tc.get(key) is not None
    cache.invalidate_path("/p")
    assert not cache.peek(cache.resolve("/p", 0, 64))


# -- sched: seeded scenarios of tests/test_sched.py and the gate's four --------


class LostUpdate:
    name = "seeded lost update"

    def __init__(self, yield_point):
        self.yield_point = yield_point

    def setup(self):
        return {"n": 0}

    def threads(self, state):
        def bump():
            v = state["n"]
            self.yield_point("n")
            state["n"] = v + 1

        return [bump, bump]

    def check(self, state):
        assert state["n"] == 2, f"lost update: n={state['n']}"


class AtomicBump(LostUpdate):
    name = "atomic locked bump"

    def setup(self):
        return {"n": 0, "lk": threading.Lock()}

    def threads(self, state):
        def bump():
            with state["lk"]:
                v = state["n"]
                self.yield_point("n")
                state["n"] = v + 1

        return [bump, bump]


class SeededDeadlock(LostUpdate):
    name = "seeded lock-order inversion"

    def setup(self):
        return {"a": threading.Lock(), "b": threading.Lock()}

    def threads(self, state):
        def ab():
            with state["a"]:
                self.yield_point("inv")
                with state["b"]:
                    pass

        def ba():
            with state["b"]:
                self.yield_point("inv")
                with state["a"]:
                    pass

        return [ab, ba]

    def check(self, state):
        pass


class Commuting(SeededDeadlock):
    name = "commuting yields"

    def setup(self):
        return {}

    def threads(self, state):
        return [lambda: self.yield_point("x"), lambda: self.yield_point("y")]


class Conflicting(Commuting):
    name = "conflicting yields"

    def setup(self):
        return {"order": []}

    def threads(self, state):
        def t(tag):
            def run():
                self.yield_point("shared")
                state["order"].append(tag)
                self.yield_point("shared")
                state["order"].append(tag)

            return run

        return [t("a"), t("b")]


class BoundedQueue(Commuting):
    name = "bounded queue handoff"

    def setup(self):
        return {"q": queue.Queue(maxsize=1), "got": []}

    def threads(self, state):
        def producer():
            state["q"].put(1)
            state["q"].put(2)

        def consumer():
            state["got"].append(state["q"].get())
            state["got"].append(state["q"].get())

        return [producer, consumer]

    def check(self, state):
        assert state["got"] == [1, 2], state["got"]


SEEDED = {
    # name: (scenario class, the reference explorer's error text or None)
    "lost_update": (LostUpdate, "lost update"),
    "atomic_bump": (AtomicBump, None),
    "seeded_deadlock": (SeededDeadlock, "DEADLOCK"),
    "commuting": (Commuting, None),
    "conflicting": (Conflicting, None),
    "bounded_queue": (BoundedQueue, None),
}


def _explore(sched, scenario, **kw):
    try:
        r = sched.explore(scenario, name_filter=lambda s: True, **kw)
    except sched.ScheduleError as e:
        msg = str(e)
        return ("error", "DEADLOCK" if "DEADLOCK" in msg else "invariant",
                [ln.strip() for ln in msg.splitlines() if ". T" in ln])
    return (r.schedules, r.pruned, r.exhausted)


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_schedules_equal_the_reference(name):
    cls, error = SEEDED[name]
    got = {side: _explore(s, cls(s.yield_point)) for side, (_l, _r, s) in SIDES.items()}
    assert got["port"] == got["ref"]
    assert (got["ref"][0] == "error") == (error is not None)


def test_max_schedules_truncates_equally():
    got = {side: _explore(s, Conflicting(s.yield_point), max_schedules=2)
           for side, (_l, _r, s) in SIDES.items()}
    assert got["port"] == got["ref"] == (2, 0, False)


@pytest.mark.parametrize("i", range(len(sc.SCENARIOS)))
def test_control_plane_scenario_counts_equal_the_reference(i):
    """Each gate scenario, the port's on the CPU: equal schedules, pruned
    branches and exhaustion, and the invariant held in every schedule."""
    ref_s, port_s = ref_sc.SCENARIOS[i], sc.SCENARIOS[i](device="cpu")
    assert port_s.name == ref_s.name and port_s.device == "cpu"
    ref, port = ref_sc.explore(ref_s), sc.explore(port_s)
    assert (port.schedules, port.pruned, port.exhausted) \
        == (ref.schedules, ref.pruned, ref.exhausted)
    assert port.exhausted and port.schedules >= 1


def test_patching_is_restored():
    real_lock, real_rlock = threading.Lock, threading.RLock
    real_put, real_get = queue.Queue.put, queue.Queue.get
    sc.explore(Commuting(sc.yield_point))
    assert threading.Lock is real_lock and threading.RLock is real_rlock
    assert queue.Queue.put is real_put and queue.Queue.get is real_get


def test_cli_runs_all_scenarios_on_cpu(capsys):
    assert sc.main(["-q", "--device", "cpu"]) == 0
    assert sc.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines() == [s.name for s in ref_sc.SCENARIOS]
    assert sc.main(["-k", "no-such-scenario", "--device", "cpu"]) == 2
    assert [s.device for s in sc.scenarios("cpu")] == ["cpu"] * len(sc.SCENARIOS)


# -- no silent CPU ---------------------------------------------------------------


def test_explorer_without_device_fails_without_a_card():
    """The explorer's device defaults to cuda, as every port entry point's
    does: without a card and without --device cpu it fails, naming the
    device, and so does a scenario that builds a worker."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device runs there")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis.sched", "-q"],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert run.returncode == 2
    assert "needs a CUDA device" in run.stderr and "sched: ok" not in run.stdout
    assert sc.ScaleDownVsDelivery().device == "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        sc.explore(sc.ScaleDownVsDelivery())
