"""The port's spans on the profiler's clock and where the work happens.

``Tracer.span`` is a ``torch.profiler`` annotation of the same name and
nesting while a profiler records, and nothing but a span otherwise;
``NULL_TRACER`` records and enters nothing.  The DLRM sparse step's
bundle records ``step.handoff`` and its three phases once a step, in
order, counts the bytes it hands off and computes bit for bit what it
computes untraced; an LM's training attention records ``attention.fwd``
in the forward and in remat's recompute and ``attention.bwd`` once a
layer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import VirtualMesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import NULL_TRACER, Tracer, metric_fields  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

DLRM_PHASES = ["step.handoff", "dlrm.pool", "dlrm.dense", "dlrm.table_update"]


class CountingClock:
    def __init__(self):
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return float(self.reads)


def _spans(tracer, names=None):
    return [s.name for s in sorted(tracer.spans(), key=lambda s: s.t0)
            if names is None or s.name in names]


def test_spans_are_profiler_annotations_of_the_same_names_and_nesting():
    tracer = Tracer()
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("outer"):
            x = x * 2.0
            with tracer.span("inner", rows=3):
                x = x + 1.0
            with tracer.span("inner"):
                x = x - 1.0
    events = {}
    for ev in prof.events():
        events.setdefault(ev.name, []).append(ev)
    assert len(events["outer"]) == 1 and len(events["inner"]) == 2
    outer = events["outer"][0]
    for ev in events["inner"]:
        assert ev.cpu_parent is outer
        assert outer.time_range.start <= ev.time_range.start <= ev.time_range.end \
            <= outer.time_range.end
    assert any(ev.name == "aten::add" for ev in events["inner"][0].cpu_children)
    assert _spans(tracer) == ["outer", "inner", "inner"]
    assert tracer.open_spans() == 0


def test_no_annotation_without_a_recording_profiler(monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    tracer = Tracer()
    with tracer.span("a"):
        with tracer.span("b"):
            pass
    assert entered == [] and _spans(tracer) == ["a", "b"]
    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("c"):
            with tracer.span("d"):
                pass
    assert entered == ["c", "d"]
    with tracer.span("e"):
        pass
    assert entered == ["c", "d"] and _spans(tracer) == ["a", "b", "c", "d", "e"]


def test_the_null_tracer_records_and_enters_nothing():
    x = torch.ones(8)
    handle = NULL_TRACER.span("a")
    assert NULL_TRACER.span("b", rows=1) is handle
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with NULL_TRACER.span("null.outer"):
            with NULL_TRACER.span("null.inner"):
                x = x + 1.0
    assert not [ev for ev in prof.events() if ev.name.startswith("null.")]
    assert NULL_TRACER.spans() == [] and NULL_TRACER.open_spans() == 0
    clock = CountingClock()
    tracer = Tracer(clock=clock)
    with tracer.span("timed"):
        pass
    assert clock.reads == 2             # an enabled span reads its clock twice


# ---------------------------------------------------------------------------
# the DLRM sparse step
# ---------------------------------------------------------------------------


def _dlrm_bundle(batch=16):
    cfg = configs.get_smoke_config("dlrm-paper")
    mesh = VirtualMesh((1, 1), ("data", "model"), device="cpu")
    return cfg, steps.make_dlrm_sparse_train_step(cfg, mesh, batch, opt_cfg=OptimizerConfig(),
                                                  device="cpu")


def _dlrm_batch(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    ids = (batch, cfg.num_tables, cfg.max_ids_per_feature)
    return {"dense": rng.standard_normal((batch, cfg.num_dense)).astype(np.float32),
            "sparse_ids": rng.integers(0, cfg.vocab_per_table, ids).astype(np.int32),
            "sparse_mask": (rng.random(ids) < 0.7).astype(np.float32),
            "label": (rng.random(batch) < 0.3).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_bundle_metrics_are_declared_counters():
    assert [(f.name, kind) for f, kind in metric_fields(steps.BundleMetrics)] == [
        ("handoff_bytes", "counter")]
    _, bundle = _dlrm_bundle()
    assert bundle.tracer is NULL_TRACER and bundle.metrics.handoff_bytes == 0


def test_dlrm_step_spans_counter_and_bits():
    cfg, bundle = _dlrm_bundle()
    batches = [_dlrm_batch(cfg, 16, s) for s in (1, 2)]
    runs = {}
    for mode in ("null", "tracer"):
        tracer = Tracer() if mode == "tracer" else NULL_TRACER
        bundle.attach_tracer(tracer)
        before = bundle.metrics.handoff_bytes
        params, opt = bundle.init_state(seed=3)
        losses = []
        for b in batches:
            params, opt, met = bundle.fn(params, opt, bundle.shard_batch(b))
            losses.append(met["loss"])
        runs[mode] = (params, opt, losses, tracer, bundle.metrics.handoff_bytes - before)
    bundle.attach_tracer(NULL_TRACER)
    (p0, o0, l0, _, n0), (p1, o1, l1, tracer, n1) = runs["null"], runs["tracer"]
    assert _spans(tracer) == DLRM_PHASES * 2
    assert tracer.open_spans() == 0
    # nothing of the step falls between its phases
    spans = sorted(tracer.spans(), key=lambda s: s.t0)
    assert all(a.t1 <= b.t0 for a, b in zip(spans, spans[1:]))
    assert n0 == n1 == sum(v.nbytes for b in batches for v in b.values())
    for a, b in zip(l0, l1):
        assert torch.equal(a, b)
    for tree0, tree1 in ((p0, p1), (o0, o1)):
        f0, f1 = _flat(tree0), _flat(tree1)
        assert f0.keys() == f1.keys()
        for k in f0:
            assert torch.equal(torch.as_tensor(f0[k]), torch.as_tensor(f1[k])), k


def test_dlrm_phases_hold_every_op_of_the_step():
    """Under the profiler every aten op the step runs lies inside one of
    its phases' annotations."""
    cfg, bundle = _dlrm_bundle()
    params, opt = bundle.init_state(seed=5)
    batch = _dlrm_batch(cfg, 16, 7)
    bundle.attach_tracer(Tracer())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bundle.fn(params, opt, bundle.shard_batch(batch))
    bundle.attach_tracer(NULL_TRACER)
    phases = [ev for ev in prof.events() if ev.name in DLRM_PHASES]
    assert [ev.name for ev in sorted(phases, key=lambda e: e.time_range.start)] == DLRM_PHASES

    def phase_of(ev):
        while ev is not None and ev.name not in DLRM_PHASES:
            ev = ev.cpu_parent
        return ev

    tops = [ev for ev in prof.events() if ev.name.startswith("aten::")
            and (ev.cpu_parent is None or not ev.cpu_parent.name.startswith("aten::"))]
    assert tops
    outside = [ev.name for ev in tops if phase_of(ev) is None]
    assert outside == []


# ---------------------------------------------------------------------------
# the LM's attention
# ---------------------------------------------------------------------------

CHUNKS = dict(attn_chunk=16, attn_k_chunk=16, logit_chunk=16)


def _lm(remat):
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-8b"), remat=remat,
                              param_dtype=torch.float32, compute_dtype=torch.float32, **CHUNKS)
    model = build_model(cfg, device="cpu")
    model.init(0)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 33)))
    return cfg, model, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("remat", [True, False])
def test_attention_spans_in_forward_recompute_and_backward(remat):
    cfg, model, batch = _lm(remat)
    assert model.tracer is NULL_TRACER
    tracer = Tracer()
    model.attach_tracer(tracer)
    loss = model.loss(batch)
    forward = _spans(tracer)
    assert forward == ["attention.fwd"] * cfg.num_layers
    loss.backward()
    model.attach_tracer(NULL_TRACER)
    names = _spans(tracer)[len(forward):]
    assert names.count("attention.bwd") == cfg.num_layers
    assert names.count("attention.fwd") == (cfg.num_layers if remat else 0)
    if remat:       # each layer's recompute runs before its backward
        assert names == ["attention.fwd", "attention.bwd"] * cfg.num_layers
    assert tracer.open_spans() == 0


def test_attention_spans_bit_identical_gradients():
    grads = []
    for tracer in (NULL_TRACER, Tracer()):
        _, model, batch = _lm(True)
        model.attach_tracer(tracer)
        model.loss(batch).backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_the_trainer_passes_its_tracer_down():
    cfg, _, batch = _lm(True)
    tracer = Tracer()
    trainer = Trainer(cfg, OptimizerConfig(warmup_steps=1), TrainerConfig(max_steps=1),
                      tracer=tracer, device="cpu")
    assert trainer.model.tracer is tracer
    trainer.fit([{k: v.numpy() for k, v in batch.items()}])
    names = _spans(tracer)
    assert names.count("attention.bwd") == cfg.num_layers
    assert names.count("attention.fwd") == 2 * cfg.num_layers
    assert "train.step" in names
    trainer.attach_tracer(NULL_TRACER)
    assert trainer.tracer is NULL_TRACER and trainer.model.tracer is NULL_TRACER


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_every_training_attention_of_the_family_records_its_spans(arch):
    """MLA, the hybrid's attention layers and the encoder-decoder's three
    attentions take the tracer their ``DecoderLM`` holds."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), param_dtype=torch.float32,
                              compute_dtype=torch.float32, **CHUNKS)
    model = build_model(cfg, device="cpu")
    model.init(0)
    gen = torch.Generator().manual_seed(0)
    batch = {k: (torch.randint(0, cfg.vocab_size, shape, generator=gen) if dtype == torch.int32
                 else torch.randn(shape, generator=gen, dtype=dtype))
             for k, (shape, dtype) in model.input_specs(2, 32, "train").items()}
    tracer = Tracer()
    model.attach_tracer(tracer)
    model.loss(batch).backward()
    names = _spans(tracer)
    assert names.count("attention.fwd") >= 1
    assert names.count("attention.bwd") == names.count("attention.fwd") // (
        2 if cfg.remat else 1)
    assert tracer.open_spans() == 0
