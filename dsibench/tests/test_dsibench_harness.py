"""The harness's arithmetic and lookups, on synthetic step logs and in a
temporary copy of the benchmark."""
import json
import re
import shutil

import pytest

from dsibench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def steps(durations, units=8, seconds=1.0):
    """A window over steps of ``durations``, run while it is due."""
    clock = Clock()
    win = harness.Window(seconds, clock=clock)
    win.open()
    for d in durations:
        start = clock.t
        clock.t += d
        win.step(start, clock.t, units, 1.0)
        if not win.due():
            break
    return win


@pytest.mark.parametrize("durations,n_steps,elapsed", [
    ([0.25] * 8, 4, 1.0),                 # ends on a step's end
    ([0.3] * 8, 4, 1.2),                  # ends inside the fourth step: counted whole
    ([0.45, 0.45, 0.45, 0.45], 3, 1.35),  # the s512 shape: 2.2 steps a second
    ([2.0], 1, 2.0),                      # one step longer than the window
])
def test_whole_step_rate(durations, n_steps, elapsed):
    win = steps(durations)
    assert len(win.steps) == n_steps
    assert win.elapsed == pytest.approx(elapsed)
    rate = harness.load_module("metrics", "lm_train_tokens_per_s").read(
        harness.Run(win, 1.0, 1, "tokens", {}, {}))
    assert rate == pytest.approx(8 * n_steps / elapsed)
    assert harness.load_module("metrics", "dlrm_train_samples_per_s").read(
        harness.Run(win, 1.0, 1, "tokens", {}, {})) is None


def test_p95_over_all_steps():
    durs = [0.01] * 95 + [0.05] * 5
    win = steps(durs, seconds=100.0)
    assert len(win.steps) == 100
    p95 = harness.load_module("metrics", "dlrm_step_ms_p95").read(
        harness.Run(win, 1.0, 1, "samples", {}, {}))
    assert p95 == pytest.approx(10.0)
    win = steps([0.01] * 94 + [0.05] * 6, seconds=100.0)
    assert harness.load_module("metrics", "dlrm_step_ms_p95").read(
        harness.Run(win, 1.0, 1, "samples", {}, {})) == pytest.approx(50.0)
    assert harness.p95([3.0]) == 3.0


def test_union_and_gaps():
    busy, gaps = harness.union_seconds([(1, 3), (2, 5), (7, 8), (9, 20)], 0, 10)
    assert busy == 6            # [1, 5), [7, 8), [9, 10)
    assert gaps == [(0, 1), (5, 7), (8, 9)]
    assert harness.union_seconds([], 0, 4) == (0.0, [(0, 4)])


def test_spans_and_shares():
    clock = Clock()
    win = harness.Window(10.0, clock=clock)
    win.open()
    for _ in range(4):
        start = clock.t
        with win.span("stall"):
            clock.t += 0.1
        clock.t += 0.9
        win.step(start, clock.t, 8192, 1.0)
    run = harness.Run(win, 1.0, 1, "tokens", {"flops": [989e12 * 0.5] * 4},
                      harness.load_json("peaks", "h100"))
    share = harness.load_module("metrics", "data_stall_share.lm").read(run)
    assert share == pytest.approx(10.0)
    assert harness.load_module("metrics", "mfu.lm").read(run) == pytest.approx(50.0)
    assert harness.load_module("metrics", "device_idle_share.lm").read(run) is None
    run.device = {"busy_s": 3.0, "window_s": 4.0}
    assert harness.load_module("metrics", "device_idle_share.lm").read(run) == pytest.approx(25.0)


@pytest.mark.parametrize("modules,found", [
    ({"jax": 1, "jax.numpy": 1, "numpy": 1}, ["jax", "jax.numpy"]),
    ({"repro_torch": 1, "repro_torch.core": 1}, []),
    ({"repro": 1, "repro.core.dwrf": 1, "reproducible": 1}, ["repro", "repro.core.dwrf"]),
    ({"flax.linen": 1, "jaxlib": 1, "jaxtyping": 1}, ["flax.linen", "jaxlib"]),
])
def test_forbidden_modules_by_whole_top_level_name(modules, found):
    assert harness.loaded_forbidden(modules) == found


def test_manifest_follows_the_contract():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    names = [c["name"] for c in man["configs"]]
    cells = [w["name"] for w in man["workloads"]]
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    for n in names + cells + metrics + [w["traffic"] for w in man["workloads"]]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        harness.load_module("metrics", m["name"])
    for m in man["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert harness.load_module("metrics", m["name"]).MOVES == m["moves"]
        for cell in m["workloads"]:
            reported = {x["name"] for x in harness.metrics_of(man, cell, False)}
            assert m["moves"] in reported
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in man["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names
        reported = harness.metrics_of(man, w["name"], False)
        assert {"setup_s"} < {m["name"] for m in reported}
        assert harness.metrics_of(man, w["name"], True)
        assert harness.load_json("traffic", w["traffic"])
        assert harness.load_json("cells", w["name"])["limits"]
    for c in man["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        harness.load_module("runners", cfg["runner"])
        harness.load_module("reference", cfg["reference"])


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """A cell and a metric added as files only, in a copy of the
    benchmark, reach the harness's lookups with no list edited."""
    base = tmp_path / "dsibench"
    shutil.copytree(harness.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = harness.manifest()
    man["workloads"].append({"name": "qwen3-8b.train.s1024", "config": "qwen3-8b",
                             "traffic": "train.s1024", "chips": 1, "why": "a new mix"})
    man["per_layer"].append({"name": "steps_share.lm", "unit": "%", "better": "higher",
                             "source": "host_clock", "layer": "trainer loop and step",
                             "moves": "lm_train_tokens_per_s",
                             "workloads": ["qwen3-8b.train.s1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    traffic = harness.load_json("traffic", "train.s512")
    traffic.update(rows=8, seq=1024)
    (base / "traffic" / "train.s1024.json").write_text(json.dumps(traffic))
    (base / "cells" / "qwen3-8b.train.s1024.json").write_text(
        json.dumps(harness.load_json("cells", "qwen3-8b.train.s512")))
    (base / "metrics" / "steps_share.lm.py").write_text(
        "MOVES = 'lm_train_tokens_per_s'\n\n\ndef read(run):\n"
        "    return 100.0 * len(run.window.steps) / 1000\n")
    man2 = harness.manifest(tmp_path)
    w = harness.workload(man2, "qwen3-8b.train.s1024")
    assert harness.load_json("traffic", w["traffic"], base)["seq"] == 1024
    assert harness.load_json("cells", w["name"], base)["limits"]
    per_layer = harness.metrics_of(man2, w["name"], True)
    assert [m["name"] for m in per_layer] == ["steps_share.lm"]
    reader = harness.load_module("metrics", "steps_share.lm", base)
    win = steps([0.5] * 3, seconds=1.0)
    assert reader.read(harness.Run(win, 1.0, 1, "tokens", {}, {})) == pytest.approx(0.2)
