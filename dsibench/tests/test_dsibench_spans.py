"""The program's spans read from a trace (``dsibench.span_trace``): the
device and idle seconds by innermost span on a synthetic event list, the
harness's own reading of the same trace left as it was, the per-step
figures the spans give, a traced window with the program's tracer
attached and detached, and the tracer's cost measured in turns."""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from dsibench import harness, span_trace, tracer_cost  # noqa: E402
from dsibench.tests import smoke  # noqa: E402
from dsibench.tests.threads import share_cores  # noqa: E402

share_cores()

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
PROGRAM = {"step.handoff", "dlrm.pool", "dlrm.dense", "dlrm.table_update"}
NUMBERS = ["handoff_gb_per_s.dlrm", "pooling_device_ms.dlrm", "dense_device_ms.dlrm",
           "table_update_device_ms.dlrm", "in_step_idle_share.dlrm",
           "dlrm_spans_share_of_busy", "attention_device_ms.lm"]


def ev(name, a, b, device=CPU, thread=1, id=0, linked=0):
    return SimpleNamespace(name=name, device_type=device, thread=thread, id=id,
                           linked_correlation_id=linked,
                           time_range=SimpleNamespace(start=a, end=b))


def trace(program=True):
    """A DLRM window of 100 us on the profiler's clock: the benchmark's
    spans, the program's (``program``) with their device-side twins, and
    ten device ops launched through runtime calls, through a linked CPU
    op only, from autograd's thread, by nothing, and past the window."""
    events = [ev("dsibench.window", 0, 100), ev("dsibench.handoff", 0, 10),
              ev("dsibench.step", 10, 90), ev("dsibench.step", 12, 88, CUDA)]
    if program:
        events += [ev("step.handoff", 1, 9), ev("dlrm.pool", 10, 30), ev("dlrm.dense", 30, 60),
                   ev("dlrm.table_update", 60, 85), ev("dlrm.pool", 12, 28, CUDA)]
    ops = [  # (name, start, end, id, launch thread, launch time)
        ("Memcpy HtoD", 2, 8, 1, 1, 2), ("gather", 12, 20, 2, 1, 11), ("sum", 22, 28, 3, 1, 21),
        ("gemm", 32, 40, 4, 1, 31), ("gemm_bwd", 42, 50, 5, 2, 41), ("mul", 48, 52, 6, 1, 47),
        ("Memcpy DtoH", 86, 88, 8, 1, 85.5), ("tail", 98, 104, 10, 1, 97)]
    for name, a, b, i, tid, t in ops:
        events += [ev(name, a, b, CUDA, id=i), ev("cudaLaunchKernel", t, t + 0.5, thread=tid, id=i)]
    events += [ev("index_add", 62, 80, CUDA, id=7, linked=500),
               ev("aten::index_add_", 61, 61.8, id=500),
               ev("orphan", 92, 95, CUDA, id=9)]
    return SimpleNamespace(events=lambda: events)


def test_innermost_by_one_sweep():
    spans = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (5, 8, "d"), (7, 7, "empty")]
    assert span_trace.innermost(spans, [9, 0, 3.5, 5, 4, 10, 7]) == [
        "a", "a", "c", "d", "b", None, "d"]
    assert span_trace.innermost([], [1.0]) == [None]


def test_read_spans_by_span():
    dev = span_trace.read_spans(trace(), PROGRAM)
    assert dev["window_s"] == pytest.approx(100e-6)
    assert dev["busy_s"] == pytest.approx(63e-6)
    got = {k: v * 1e6 for k, v in dev["device_s_by_span"].items()}
    assert got == pytest.approx({"step.handoff": 6, "dlrm.pool": 14, "dlrm.dense": 18,
                                 "dlrm.table_update": 18, "step": 2, "host": 5})
    assert sum(dev["device_s_by_span"].values()) == pytest.approx(dev["busy_s"])
    idle = {k: v * 1e6 for k, v in dev["idle_s_by_span"].items()}
    assert idle == pytest.approx({"handoff": 2, "step.handoff": 4, "dlrm.pool": 6,
                                  "dlrm.dense": 12, "dlrm.table_update": 6, "step": 4,
                                  "host": 3})
    assert [n for n, _ in dev["idle_gaps"]] == [
        "dlrm.dense", "dlrm.table_update", "step.handoff", "dlrm.pool", "step", "host",
        "handoff", "dlrm.pool", "dlrm.dense"]
    assert dev["idle_gaps"][0][1] == pytest.approx(10e-6)
    names = [n for n, _ in dev["device_ops"]]
    assert "dlrm.pool" not in names and "dsibench.step" not in names


def test_read_spans_of_a_program_without_spans():
    """A trace of a program that records no spans: only the benchmark's
    spans name anything, and busy seconds, device operations and the
    longest gaps are the harness's own ``read_trace``'s."""
    dev = span_trace.read_spans(trace(program=False))
    accepted = harness.read_trace(trace(program=False))
    assert dev["busy_s"] == pytest.approx(63e-6)
    assert set(dev["device_s_by_span"]) == {"handoff", "step", "host"}
    for key in ("busy_s", "window_s", "device_ops", "idle_gaps"):
        assert dev[key] == accepted[key], key
    with_spans = span_trace.read_spans(trace(), PROGRAM)
    assert with_spans["busy_s"] == dev["busy_s"]
    assert with_spans["device_ops"] == dev["device_ops"]


def test_numbers_of_the_program_spans():
    dev = span_trace.read_spans(trace(), PROGRAM)
    span_s = {"step.handoff": 0.004 + 0.006, "dlrm.pool": 0.01}
    got = span_trace.numbers(2, dev, span_s, {"handoff_bytes": 52_000_000})
    assert set(got) == set(NUMBERS)
    assert got["handoff_gb_per_s.dlrm"] == pytest.approx(5.2)
    assert got["pooling_device_ms.dlrm"] == pytest.approx(14e-3 / 2)
    assert got["dense_device_ms.dlrm"] == pytest.approx(18e-3 / 2)
    assert got["table_update_device_ms.dlrm"] == pytest.approx(18e-3 / 2)
    assert got["in_step_idle_share.dlrm"] == pytest.approx(24.0)
    assert got["dlrm_spans_share_of_busy"] == pytest.approx(100.0 * 56 / 63)
    assert got["attention_device_ms.lm"] is None
    lm = {"busy_s": 2.0, "window_s": 2.1, "idle_s_by_span": {"step": 0.1},
          "device_s_by_span": {"attention.fwd": 0.3, "attention.bwd": 0.5, "step": 1.0}}
    got = span_trace.numbers(2, lm, {"attention.fwd": 0.01}, {})
    assert got["attention_device_ms.lm"] == pytest.approx(400.0)
    assert all(got[n] is None for n in NUMBERS[:-1])


def test_numbers_of_a_program_without_spans():
    """Nothing to read where the program recorded no spans: every figure
    is None, none is zero."""
    dev = span_trace.read_spans(trace(program=False))
    got = span_trace.numbers(2, dev, {}, {})
    assert all(v is None for v in got.values())
    assert all(v is None for v in span_trace.numbers(0, {}, {}, {}).values())


@pytest.mark.parametrize("cell,names", [
    ("dlrm-paper.train.b4096", {"step.handoff", "dlrm.pool", "dlrm.dense",
                                "dlrm.table_update"}),
    ("qwen3-8b.train.s512", {"attention.fwd", "attention.bwd"}),
])
def test_traced_window_attaches_the_tracer_and_detaches_it(cell, names, monkeypatch):
    """A traced window at smoke size on the CPU: the program's spans are
    recorded and are annotations of the profiler's window, the bundle's
    hand-off bytes are the window's batches', and the step is left with
    ``NULL_TRACER``.  The CPU's trace has no device time to read."""
    from repro_torch.obs import NULL_TRACER

    seen = {}
    real = span_trace.session_of

    def keep(*args, **kwargs):
        seen["session"], seen["target"] = real(*args, **kwargs)
        return seen["session"], seen["target"]

    read = span_trace.read_spans

    def annotations(prof, program):
        seen["annotated"] = {ev.name for ev in prof.events()} & set(program)
        return read(prof, program)

    monkeypatch.setattr(span_trace, "session_of", keep)
    monkeypatch.setattr(span_trace, "read_spans", annotations)
    out = span_trace.traced_window(cell, smoke.SEED, 0.05, "cpu", smoke.OVERRIDES[cell])
    assert out["steps"] >= 1 and out["busy_s"] is None
    assert names <= set(out["span_s"]) and names <= seen["annotated"]
    assert seen["target"].tracer is NULL_TRACER
    if cell.startswith("dlrm"):
        batch = sum(v.nbytes for v in seen["session"].pool[0].values())
        assert out["counters"]["handoff_bytes"] == out["steps"] * batch
        assert out["numbers"]["handoff_gb_per_s.dlrm"] > 0
    else:
        assert out["counters"] == {}
    assert all(out["numbers"][n] is None for n in NUMBERS if n != "handoff_gb_per_s.dlrm")


def test_tracer_cost_runs_in_turns():
    cell = "dlrm-paper.train.b4096"
    rows = []
    out = tracer_cost.measure(cell, smoke.SEED, 0.05, 2, "cpu", smoke.OVERRIDES[cell],
                              emit=rows.append)
    assert [r["mode"] for r in rows] == ["null", "tracer", "tracer", "null"]
    assert all((r["spans"] > 0) == (r["mode"] == "tracer") for r in rows)
    assert all(r["steps"] >= 1 and r["rate"] > 0 for r in rows)
    assert set(out) >= {"null", "tracer", "rate_change_pct", "step_change_pct"}
