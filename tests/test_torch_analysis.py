"""The port's invariant gate (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

Every lock, clock, metrics, span, thread and race fixture of
``tests/test_analysis.py``, and its noqa and baseline fixtures, is written
once under ``src/repro/`` (``benchmarks/``) for the reference and once under
``src/repro_torch/`` (``benchmarks/torch/``) for the port, as throwaway
mini-repos under ``tmp_path``; both packages must report the same findings
(rule, path, line, symbol and message) once the path prefix is mapped.  The
kernel-parity rules read the port's own layout (the ``.cu`` op table, the
port's differential suites), so they get fixtures of their own.  The CLI
tests pin the exit codes: 0 clean, 1 on new findings, 2 on usage errors.
"""
from __future__ import annotations

import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro import analysis as ref_analysis  # noqa: E402
from repro_torch import analysis as port_analysis  # noqa: E402
from repro_torch.analysis import all_rules, load_baseline, run_checks  # noqa: E402
from repro_torch.analysis.__main__ import main as cli_main  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# where each package's fixtures live: {src} and {bench} in a fixture's paths
LAYOUT = {
    "ref": {"src": "src/repro", "bench": "benchmarks"},
    "port": {"src": "src/repro_torch", "bench": "benchmarks/torch"},
}
PACKAGES = {"ref": ref_analysis, "port": port_analysis}


def _write(root: Path, files: dict, layout: dict) -> Path:
    (root / layout["src"]).mkdir(parents=True, exist_ok=True)
    for rel, text in files.items():
        p = root / rel.format(**layout)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return root


def _unmap(path: str) -> str:
    """A port path in the reference's layout."""
    for side in ("src", "bench"):
        port, ref = LAYOUT["port"][side], LAYOUT["ref"][side]
        if path.startswith(port + "/"):
            return ref + path[len(port):]
    return path


def _rows(findings, port: bool):
    return [(f.rule, _unmap(f.path) if port else f.path, f.line, f.symbol, f.message)
            for f in findings]


# -- the reference's fixtures, each as (rule, files, findings it must give) --

LOCKED_HEADER = """\
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.x = 0
            self._items = []
"""

WORKER_METRICS = """\
    import dataclasses

    from repro.obs import counter, gauge

    @dataclasses.dataclass
    class WorkerMetrics:
        batches: int = counter()
        bytes_read: int = counter()
        bytes_stored: int = gauge()
"""

RACED_WORKER_HEADER = """\
    import threading

    class DPPWorker:
        def __init__(self):
            self._lock = threading.Lock()
            self.alive = True
"""

FS_PUBLISHED = """\
    import threading

    class FS:
        def __init__(self):
            self._lock = threading.Lock()
            self.{attr} = None

        def attach(self, c):
            with self._lock:
                self.{attr} = c
"""

FIXTURES = {
    # REPRO-L001
    "l001_assign_outside_lock": ("REPRO-L001", {"{src}/m.py": LOCKED_HEADER + """\

        def bump(self):
            self.x += 1
    """}, 1),
    "l001_mutator_call_outside_lock": ("REPRO-L001", {"{src}/m.py": LOCKED_HEADER + """\

        def push(self, v):
            self._items.append(v)
    """}, 1),
    "l001_negative_mutation_under_lock": ("REPRO-L001", {"{src}/m.py": LOCKED_HEADER + """\

        def bump(self):
            with self._lock:
                self.x += 1
                self._items.append(self.x)
    """}, 0),
    "l001_negative_class_without_lock": ("REPRO-L001", {"{src}/m.py": """\
        class Plain:
            def __init__(self):
                self.x = 0
            def bump(self):
                self.x += 1
    """}, 0),
    # REPRO-L002
    "l002_locked_helper_acquires_lock": ("REPRO-L002", {"{src}/m.py": LOCKED_HEADER + """\

        def _bump_locked(self):
            with self._lock:
                self.x += 1
    """}, 1),
    "l002_locked_helper_called_outside_lock": ("REPRO-L002", {"{src}/m.py": LOCKED_HEADER + """\

        def _bump_locked(self):
            self.x += 1

        def bump(self):
            self._bump_locked()
    """}, 1),
    "l002_negative_called_under_lock": ("REPRO-L002", {"{src}/m.py": LOCKED_HEADER + """\

        def _bump_locked(self):
            self.x += 1

        def bump(self):
            with self._lock:
                self._bump_locked()
    """}, 0),
    # REPRO-L003
    "l003_private_helper_without_suffix": ("REPRO-L003", {"{src}/m.py": LOCKED_HEADER + """\

        def _drain(self):
            self._items.clear()

        def flush(self):
            with self._lock:
                self._drain()
    """}, 1),
    "l003_uncalled_private_helper": ("REPRO-L003", {"{src}/m.py": LOCKED_HEADER + """\

        def _reset(self):
            self.x = 0
    """}, 1),
    "l003_negative_suffixed_helper": ("REPRO-L003", {"{src}/m.py": LOCKED_HEADER + """\

        def _drain_locked(self):
            self._items.clear()
    """}, 0),
    "l003_negative_init_only_callee": ("REPRO-L003", {"{src}/m.py": """\
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.x = 0
                self._seed()

            def _seed(self):
                self.x = 42
    """}, 0),
    # REPRO-C001
    "c001_time_time_in_dpp": ("REPRO-C001", {"{src}/core/dpp/m.py": """\
        import time

        def deadline(s):
            return time.time() + s
    """}, 1),
    "c001_time_monotonic_in_cache": ("REPRO-C001", {"{src}/core/cache/m.py": """\
        import time

        class T:
            def now(self):
                return time.monotonic()
    """}, 1),
    "c001_negative_injection_default_and_scope": ("REPRO-C001", {
        "{src}/core/dpp/m.py": """\
            import time

            class M:
                def __init__(self, clock=time.time):
                    self._clock = clock

                def now(self):
                    t0 = time.perf_counter()
                    return self._clock(), time.perf_counter() - t0
        """,
        "{src}/core/other.py": """\
            import time

            def wall():
                return time.time()
        """,
    }, 0),
    # REPRO-M001 / M002
    "m001_unknown_field_on_getter_local": ("REPRO-M001", {
        "{src}/core/dpp/worker.py": WORKER_METRICS,
        "{bench}/bench_x.py": """\
            def main(sess):
                m = sess.worker_metrics()
                return m.batches + m.bogus_field
        """,
    }, 1),
    "m001_unknown_field_on_metrics_chain": ("REPRO-M001", {
        "{src}/core/dpp/worker.py": WORKER_METRICS,
        "{bench}/bench_x.py": """\
            def main(sess):
                return sess.prefetcher.metrics.nonexistent
        """,
    }, 1),
    "m001_negative_known_fields_and_reassignment": ("REPRO-M001", {
        "{src}/core/dpp/worker.py": WORKER_METRICS,
        "{bench}/bench_x.py": """\
            def main(sess, table, p):
                m = sess.worker_metrics()
                total = m.batches + m.bytes_read
                m = table.partitions[p]        # tracking must drop here
                return total + m.footer.num_rows
        """,
    }, 0),
    "m002_counter_decrements": ("REPRO-M002", {
        "{src}/core/dpp/worker.py": WORKER_METRICS,
        "{src}/core/foo.py": """\
            def oops(m):
                m.batches -= 1
                m.bytes_read = m.bytes_read - 4
        """,
    }, 2),
    "m002_negative_gauge_and_increment": ("REPRO-M002", {
        "{src}/core/dpp/worker.py": WORKER_METRICS,
        "{src}/core/foo.py": """\
            def fine(m, n):
                m.batches += 1
                m.bytes_stored -= n      # gauge: eviction shrinks it
        """,
    }, 0),
    "m001_drift_when_no_metric_class_discovered": ("REPRO-M001", {
        "{src}/core/foo.py": """\
            import dataclasses

            @dataclasses.dataclass
            class NotMetrics:
                batches: int = 0
        """,
    }, 1),
    "m001_discovery_needs_no_hand_kept_list": ("REPRO-M001", {
        "{src}/core/shiny/new_module.py": WORKER_METRICS,
        "{bench}/bench_x.py": """\
            def main(sess):
                m = sess.worker_metrics()
                return m.batches + m.bytes_stored + m.bogus
        """,
    }, 1),
    # REPRO-S001
    "s001_span_assigned_to_variable": ("REPRO-S001", {"{src}/core/foo.py": """\
        class Thing:
            def work(self):
                h = self.tracer.span("storage.read")
                h.__enter__()
    """}, 1),
    "s001_bare_span_call_expression": ("REPRO-S001", {"{src}/core/foo.py": """\
        def work(tracer):
            tracer.span("cache.fill", bytes=1)
    """}, 1),
    "s001_with_span_and_atomic_apis_ok": ("REPRO-S001", {"{src}/core/foo.py": """\
        class Thing:
            def work(self, row):
                with self.tracer.span("storage.read") as sp:
                    sp.set(bytes=2)
                self.tracer.record("client.stall", 0.0, 1.0)
                self.tracer.instant("cache.hit")
                return row.span("not-a-tracer")   # unrelated .span method
    """}, 0),
    "s001_scope_is_core_only": ("REPRO-S001", {"{src}/train/foo.py": """\
        def work(tracer):
            return tracer.span("train.step")
    """}, 0),
    # REPRO-T001 / T002
    "t001_unbound_thread_never_joined": ("REPRO-T001", {"{src}/m.py": """\
        import threading

        def fire(fn):
            threading.Thread(target=fn).start()
    """}, 1),
    "t001_bound_thread_never_joined": ("REPRO-T001", {"{src}/m.py": """\
        import threading

        class S:
            def start(self):
                self._t = threading.Thread(target=self.run)
                self._t.start()
    """}, 1),
    "t001_negative_daemon_join_and_loop_join": ("REPRO-T001", {"{src}/m.py": """\
        import threading

        def a(fn):
            threading.Thread(target=fn, daemon=True).start()

        def b(fn):
            t = threading.Thread(target=fn)
            t.start()
            t.join()

        def c(fns):
            ts = [threading.Thread(target=f) for f in fns]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
    """}, 0),
    "t002_bare_except": ("REPRO-T002", {"{src}/m.py": """\
        def a():
            try:
                risky()
            except:
                pass

        def b():
            try:
                risky()
            except:
                return None
    """}, 2),
    "t002_negative_typed_except": ("REPRO-T002", {"{src}/m.py": """\
        def a():
            try:
                risky()
            except Exception:
                pass
            except (KeyError, ValueError) as e:
                raise e
    """}, 0),
    # inline noqa
    "noqa_on_finding_line": ("REPRO-L001", {"{src}/m.py": LOCKED_HEADER + """\

        def bump(self):
            self.x += 1  # repro: noqa(REPRO-L001)
    """}, 0),
    "noqa_on_line_above_and_bare": ("REPRO-L001", {"{src}/m.py": LOCKED_HEADER + """\

        def bump(self):
            # repro: noqa
            self.x += 1
    """}, 0),
    "noqa_for_other_rule_does_not_suppress": ("REPRO-L001", {"{src}/m.py": LOCKED_HEADER + """\

        def bump(self):
            self.x += 1  # repro: noqa(REPRO-T001)
    """}, 1),
    # REPRO-R001
    "r001_unlocked_assign_on_instrumented_class": ("REPRO-R001", {
        "{src}/core/dpp/worker.py": RACED_WORKER_HEADER + """\

        def _run(self):
            self.alive = False
    """}, 1),
    "r001_lockless_instrumented_class_flagged": ("REPRO-R001", {
        "{src}/core/dpp/prefetch.py": """\
        class PrefetchPlanner:
            def __init__(self):
                self.depth = 4

            def set_depth(self, d):
                self.depth = d
    """}, 1),
    "r001_negative_unshared_declaration": ("REPRO-R001", {
        "{src}/core/dpp/prefetch.py": """\
        class PrefetchPlanner:
            _unshared = ("depth",)

            def __init__(self):
                self.depth = 4

            def set_depth(self, d):
                self.depth = d
    """}, 0),
    "r001_negative_assign_under_lock_or_elsewhere": ("REPRO-R001", {
        "{src}/core/dpp/worker.py": RACED_WORKER_HEADER + """\

        def _run(self):
            with self._lock:
                self.alive = False
    """,
        "{src}/other.py": """\
        class Uninstrumented:
            def __init__(self):
                self.alive = True

            def _run(self):
                self.alive = False
    """}, 0),
    # REPRO-R002
    "r002_unlocked_test_of_published_attr": ("REPRO-R002", {
        "{src}/fs.py": FS_PUBLISHED.format(attr="cache") + """\

        def read(self):
            if self.cache is None:
                return 0
            return 1
    """}, 1),
    "r002_chained_attr_test_flagged": ("REPRO-R002", {
        "{src}/fs.py": FS_PUBLISHED.format(attr="tracer") + """\

        def read(self):
            if self.tracer.enabled:
                return 1
            return 0
    """}, 1),
    "r002_negative_snapshot_into_local": ("REPRO-R002", {
        "{src}/fs.py": FS_PUBLISHED.format(attr="cache") + """\

        def read(self):
            with self._lock:
                cache = self.cache
            if cache is None:
                return 0
            return 1
    """}, 0),
}


def _both(tmp_path: Path, files: dict, rule: str, baseline=None):
    """Findings of each package on the fixture written in its layout."""
    out = {}
    for name, pkg in PACKAGES.items():
        root = _write(tmp_path / name, files, LAYOUT[name])
        new, known = pkg.run_checks(root, rules=[rule], baseline=baseline.get(name)
                                    if baseline else None)
        out[name] = (new, known)
    return out


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_fixture_findings_equal_the_reference(tmp_path, case):
    rule, files, n = FIXTURES[case]
    got = _both(tmp_path, files, rule)
    ref_rows = _rows(got["ref"][0], port=False)
    assert len(ref_rows) == n, ref_rows           # the fixture still bites
    assert _rows(got["port"][0], port=True) == ref_rows


def test_baseline_fixture_equals_the_reference(tmp_path):
    """Known findings move to ``known`` by their line-free key, in both
    packages, and stay there after the source shifts by a line."""
    files = {"{src}/m.py": LOCKED_HEADER + """\

        def bump(self):
            self.x += 1
    """}
    first = _both(tmp_path, files, "REPRO-L001")
    keys = {name: [first[name][0][0].key] for name in PACKAGES}
    assert keys["port"][0] == keys["ref"][0].replace("src/repro/", "src/repro_torch/")
    for shift in (False, True):
        if shift:
            for name in PACKAGES:
                p = tmp_path / name / LAYOUT[name]["src"] / "m.py"
                p.write_text("\n" + p.read_text())
        runs = {name: PACKAGES[name].run_checks(tmp_path / name, rules=["REPRO-L001"],
                                                 baseline=keys[name])
                for name in PACKAGES}
        for name, (new, known) in runs.items():
            assert new == [] and len(known) == 1, name
        assert (_rows(runs["port"][1], port=True)
                == _rows(runs["ref"][1], port=False))


# -- the rule catalog -----------------------------------------------------------


def test_rule_catalog_equals_the_reference():
    assert sorted(all_rules()) == sorted(ref_analysis.all_rules()) == [
        "REPRO-C001",
        "REPRO-K001", "REPRO-K002",
        "REPRO-L001", "REPRO-L002", "REPRO-L003",
        "REPRO-M001", "REPRO-M002",
        "REPRO-R001", "REPRO-R002",
        "REPRO-S001",
        "REPRO-T001", "REPRO-T002",
    ]
    # only K002's summary names a test file, the port's own
    for rid, summary in all_rules().items():
        if rid != "REPRO-K002":
            assert summary == ref_analysis.all_rules()[rid], rid
    assert "tests/test_torch_engines.py" in all_rules()["REPRO-K002"]


def test_race_rules_read_the_ports_classes():
    from repro.analysis import racedep as ref_rd
    from repro_torch.analysis import racedep as rd

    assert {_unmap(k): v for k, v in rd.INSTRUMENTED_CLASSES.items()} \
        == ref_rd.INSTRUMENTED_CLASSES
    classes = rd.core_classes()
    assert [c.__name__ for c in classes] == [c.__name__ for c in ref_rd.core_classes()]
    assert all(c.__module__.startswith("repro_torch.core.") for c in classes)


# -- REPRO-K001/K002 over the port's layout ------------------------------------

CU = "src/repro_torch/csrc/fused_transform.cu"
PLAIN = "src/repro_torch/kernels/ref.py"
ENGINES = "tests/test_torch_engines.py"


def _cu(*ops) -> str:
    """A fused-transform source whose op table is ``ops`` ((name, value)),
    inside an anonymous namespace as the real one is."""
    table = "".join(f"constexpr int {n} = {v};\n" for n, v in ops)
    return ("// header comment naming OP_GHOST = 9 in prose\n#include <stdint.h>\n"
            "namespace {\n\n" + table + "constexpr int kThreads = 256;\n}\n")


def _plain(*ops) -> str:
    return "".join(f"{n} = {v}\n" for n, v in ops)


def _k_repo(tmp_path, files: dict) -> Path:
    return _write(tmp_path, files, LAYOUT["port"])


def _k(tmp_path, rule, files):
    new, _ = run_checks(_k_repo(tmp_path, files), rules=[rule])
    return new


def test_k001_op_missing_from_plain_version(tmp_path):
    f = _k(tmp_path, "REPRO-K001", {
        CU: _cu(("OP_FOO", 0), ("OP_BAZ", 1)), PLAIN: _plain(("OP_FOO", 0)),
        ENGINES: "OP_FOO OP_BAZ"})
    assert len(f) == 1 and "OP_BAZ" in f[0].message and "no parity oracle" in f[0].message
    assert f[0].path == CU and f[0].line == 6      # the constexpr's own line


def test_k001_op_missing_from_the_cu_is_a_dead_oracle(tmp_path):
    f = _k(tmp_path, "REPRO-K001", {
        CU: _cu(("OP_FOO", 0)), PLAIN: _plain(("OP_FOO", 0), ("OP_QUX", 1)),
        ENGINES: "OP_FOO"})
    assert len(f) == 1 and f[0].path == PLAIN
    assert "OP_QUX" in f[0].message and "missing CUDA implementation" in f[0].message


def test_k001_value_mismatch(tmp_path):
    f = _k(tmp_path, "REPRO-K001", {
        CU: _cu(("OP_FOO", 0), ("OP_BAR", 2)), PLAIN: _plain(("OP_FOO", 0), ("OP_BAR", 3)),
        ENGINES: "OP_FOO OP_BAR"})
    assert len(f) == 1 and "OP_BAR = 2" in f[0].message and "diverge" in f[0].message


def test_k001_negative_matching_tables_and_prose(tmp_path):
    # OP_GHOST in a comment is no definition; indentation is allowed
    cu = _cu(("OP_FOO", 0)).replace("constexpr int OP_FOO", "  constexpr int OP_FOO")
    assert _k(tmp_path, "REPRO-K001", {
        CU: cu, PLAIN: _plain(("OP_FOO", 0)), ENGINES: "x"}) == []


def test_k001_kernel_source_missing(tmp_path):
    f = _k(tmp_path, "REPRO-K001", {PLAIN: _plain(("OP_FOO", 0))})
    assert len(f) == 1 and f[0].path == CU and "missing" in f[0].message


def test_k002_op_not_exercised(tmp_path):
    f = _k(tmp_path, "REPRO-K002", {
        CU: _cu(("OP_FOO", 0), ("OP_BAR", 1)), PLAIN: _plain(("OP_FOO", 0), ("OP_BAR", 1)),
        ENGINES: "def test_foo():\n    use('OP_FOO')\n"})
    assert len(f) == 1 and "OP_BAR" in f[0].message and ENGINES in f[0].message


def test_k002_negative_transform_name_counts_and_suite_missing(tmp_path):
    ops = (("OP_SIGRID_HASH", 1), ("OP_CLAMP_F", 5))
    assert _k(tmp_path / "a", "REPRO-K002", {
        CU: _cu(*ops), PLAIN: _plain(*ops),
        ENGINES: 'TransformSpec("SigridHash", ...); TransformSpec("Clamp", ...)'}) == []
    f = _k(tmp_path / "b", "REPRO-K002", {CU: _cu(*ops), PLAIN: _plain(*ops)})
    assert len(f) == 1 and "suite missing" in f[0].message


OPS = "src/repro_torch/kernels/ops.py"
DECODE = "src/repro_torch/kernels/decode.py"
OPS_SRC = """\
    def embedding_bag(t, i, m):
        return t

    def flash_attention(q, k, v):
        return q

    def _on_cpu(t):
        return True
"""
DECODE_SRC = """\
    def xor_decrypt(w):
        return w

    def dense_unpack_route(b):
        return "warp"

    def _stream():
        return 0
"""
BASE = {CU: _cu(("OP_FOO", 0)), PLAIN: _plain(("OP_FOO", 0)), ENGINES: "OP_FOO"}


def test_k002_dispatch_kernel_named_by_no_port_suite(tmp_path):
    f = _k(tmp_path, "REPRO-K002", {**BASE, OPS: OPS_SRC,
                                    "tests/test_torch_kernels.py": "embedding_bag(1, 2, 3)\n"})
    assert len(f) == 1 and f[0].path == OPS and "'flash_attention'" in f[0].message
    assert "tests/test_torch_lm.py" in f[0].message


def test_k002_dispatch_kernels_named_across_the_suites(tmp_path):
    # any one of the four CPU differential files names a kernel
    assert _k(tmp_path / "a", "REPRO-K002", {
        **BASE, OPS: OPS_SRC, "tests/test_torch_standalone.py": "embedding_bag\n",
        "tests/test_torch_lm.py": "flash_attention(q, k, v)\n"}) == []
    f = _k(tmp_path / "b", "REPRO-K002", {**BASE, OPS: OPS_SRC})
    assert len(f) == 1 and "suites missing" in f[0].message
    assert f[0].path == "tests/test_torch_kernels.py"


def test_k002_decode_kernel_named_by_no_port_suite(tmp_path):
    f = _k(tmp_path, "REPRO-K002", {**BASE, DECODE: DECODE_SRC,
                                    "tests/test_torch_kernels.py": "xor_decrypt\n"})
    assert len(f) == 1 and f[0].path == DECODE and "'dense_unpack_route'" in f[0].message
    assert "tests/test_torch_kernel_routes.py" in f[0].message


def test_k002_decode_kernels_named_by_the_routes_suite(tmp_path):
    assert _k(tmp_path / "a", "REPRO-K002", {
        **BASE, DECODE: DECODE_SRC,
        "tests/test_torch_kernel_routes.py": "xor_decrypt, dense_unpack_route\n"}) == []
    f = _k(tmp_path / "b", "REPRO-K002", {**BASE, DECODE: DECODE_SRC})
    assert len(f) == 1 and "decode differential suites missing" in f[0].message


def test_k_rules_on_the_real_tree():
    """The real op tables agree (OP_IDENTITY included) and every op,
    dispatch kernel and decode kernel is named by its suites."""
    from repro_torch.analysis.checks_kernels import _cu_op_defs
    from repro_torch.kernels import ref

    cu_ops = _cu_op_defs((REPO / CU).read_text())
    assert {n: v for n, (v, _line) in cu_ops.items()} == {
        n: getattr(ref, n) for n in vars(ref) if n.startswith("OP_")}
    assert cu_ops["OP_IDENTITY"][0] == 0
    new, known = run_checks(REPO, rules=["REPRO-K001", "REPRO-K002"])
    assert new == [] and known == []


# -- the CLI ---------------------------------------------------------------------


def _violation(tmp_path) -> Path:
    return _write(tmp_path, {"{src}/m.py": LOCKED_HEADER + """\

        def bump(self):
            self.x += 1
    """}, LAYOUT["port"])


def test_cli_clean_on_real_tree():
    assert cli_main(["--root", str(REPO), "-q"]) == 0


def test_cli_real_baseline_is_empty():
    path = REPO / "scripts" / "analysis_baseline_torch.txt"
    assert path.is_file() and load_baseline(path) == []


def test_cli_fails_on_violation(tmp_path, capsys):
    repo = _violation(tmp_path)
    rc = cli_main(["--root", str(repo), "--no-baseline", "--rules", "REPRO-L001"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "REPRO-L001" in out and "src/repro_torch/m.py" in out and "FAIL" in out


def test_cli_usage_errors(tmp_path):
    repo = _write(tmp_path, {"{src}/m.py": "x = 1\n"}, LAYOUT["port"])
    assert cli_main(["--root", str(repo), "--rules", "REPRO-Z999"]) == 2
    with pytest.raises(SystemExit) as ei:
        cli_main(["--no-such-flag"])
    assert ei.value.code == 2


def test_cli_write_baseline_roundtrip(tmp_path, capsys):
    repo = _violation(tmp_path)
    base = repo / "scripts" / "analysis_baseline_torch.txt"
    args = ["--root", str(repo), "--rules", "REPRO-L001"]
    assert cli_main(args) == 1                    # the default baseline path is empty
    assert cli_main(args + ["--write-baseline"]) == 0
    assert len(load_baseline(base)) == 1
    assert base.read_text().startswith("# repro_torch.analysis baseline")
    assert cli_main(args) == 0                    # baselined -> green
    assert cli_main(args + ["--no-baseline"]) == 1
    capsys.readouterr()


def test_cli_list_rules_and_json(tmp_path, capsys):
    import json

    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [ln.split()[0] for ln in out.splitlines()] == sorted(ref_analysis.all_rules())
    repo = _violation(tmp_path)
    assert cli_main(["--root", str(repo), "--json", "--rules", "REPRO-L001"]) == 1
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["rule"], r["path"], r["status"]) for r in rows] == [
        ("REPRO-L001", "src/repro_torch/m.py", "new")]
