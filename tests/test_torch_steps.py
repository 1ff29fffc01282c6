"""The port's step layout against the reference's, with no ranks.

``partition_specs`` of every arch's ``CONFIG`` and ``SMOKE`` parameter
tree (the port's ``stacked_param_specs``, the reference's
``param_specs``) under ``TRAIN_RULES``, ``FSDP_RULES`` and
``SERVE_RULES`` on meshes (2, 2), (1, 4), (16, 16) and (2, 16, 16);
``SHAPES``, ``SMOKE_SHAPES`` and ``cell_supported``; ``abstract()``'s
shapes and dtypes; ``batch_shardings`` of every mode's ``input_specs``;
and ``make_step``'s specs with its default rules.  Both
``logical_to_spec``s read only ``mesh.axis_names`` and ``mesh.shape``,
so a stub mesh serves both and no device is needed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch.steps import batch_shardings as j_batch_shardings  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.common import partition_specs as j_partition_specs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import flatten  # noqa: E402
from repro_torch.distributed import sharding as psh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import abstract_params, partition_specs  # noqa: E402
from repro_torch.models.dlrm import DLRM, DLRMConfig  # noqa: E402

MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
RULES = ["TRAIN_RULES", "FSDP_RULES", "SERVE_RULES"]
VARIANTS = ["CONFIG", "SMOKE"]


class StubMesh:
    """What ``logical_to_spec`` reads, a coordinate and a device."""

    def __init__(self, name):
        shape, axes = MESHES[name]
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.device = torch.device("cpu")

    def coord(self, axis):
        return 0


def _cfgs(arch, variant):
    get = {"CONFIG": (configs.get_config, jconfigs.get_config),
           "SMOKE": (configs.get_smoke_config, jconfigs.get_smoke_config)}[variant]
    return get[0](arch), get[1](arch)


def _port_model(cfg):
    if isinstance(cfg, DLRMConfig):
        return DLRM(cfg, tables=False, device="cpu")
    return build_model(cfg, device="meta")


def _port_specs(cfg):
    model = _port_model(cfg)
    return model.param_specs() if isinstance(model, DLRM) else model.stacked_param_specs()


def _same(got, want):
    assert isinstance(got, psh.P)
    assert tuple(got) == tuple(want) and repr(got) == repr(want)


def _dtype(d):
    return str(d).split(".")[-1]


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_partition_specs_match_reference(arch, variant, rules):
    """Every leaf names its logical axes; its spec on each mesh is the
    reference's."""
    cfg, jcfg = _cfgs(arch, variant)
    port_tree, ref_tree = _port_specs(cfg), j_build_model(jcfg).param_specs()
    port, ref = flatten(port_tree), flatten(ref_tree)
    assert list(port) == list(ref)
    for k, spec in port.items():
        assert spec.logical == ref[k].logical and spec.shape == ref[k].shape, k
    for name in MESHES:
        mesh = StubMesh(name)
        got = flatten(partition_specs(port_tree, getattr(psh, rules), mesh))
        want = flatten(j_partition_specs(ref_tree, getattr(jsh, rules), mesh))
        for k in want:
            _same(got[k], want[k])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_abstract_matches_reference(arch, variant):
    """``abstract()``: meta tensors of the reference's shapes and dtypes."""
    cfg, jcfg = _cfgs(arch, variant)
    got = flatten(_port_model(cfg).abstract())
    want = flatten(j_build_model(jcfg).abstract())
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape and _dtype(t.dtype) == _dtype(want[k].dtype), k


def test_abstract_params_and_dlrm_init():
    """``abstract_params`` of a nested tree; ``DLRM.init(seed)`` redraws
    the weights from the seed and returns the model."""
    from repro_torch.models.common import ParamSpec

    tree = abstract_params({"a": {"w": ParamSpec((3, 4), torch.bfloat16)},
                            "b": ParamSpec((5,), torch.float32)})
    assert tree["a"]["w"].shape == (3, 4) and tree["a"]["w"].dtype == torch.bfloat16
    assert tree["b"].device.type == "meta"
    model = DLRM(configs.get_smoke_config("dlrm-paper"), device="cpu")
    before = {k: p.detach().clone() for k, p in model.params().items()}
    assert model.init(7) is model
    after = model.params()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert all(torch.equal(a, b) for a, b in zip(
        after.values(), DLRM(configs.get_smoke_config("dlrm-paper"), device="cpu")
        .init(7).params().values()))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shapes_and_cells_match_reference(arch):
    assert configs.SHAPES == {k: configs.ShapeSpec(*_fields(v))
                              for k, v in jconfigs.SHAPES.items()}
    assert configs.SMOKE_SHAPES == {k: configs.ShapeSpec(*_fields(v))
                                    for k, v in jconfigs.SMOKE_SHAPES.items()}
    for shape in jconfigs.SHAPES:
        assert configs.cell_supported(arch, shape) == jconfigs.cell_supported(arch, shape)


def _fields(s):
    return s.name, s.seq_len, s.global_batch, s.mode


def _shape_of(v):
    return v[0] if isinstance(v, tuple) else tuple(v.shape)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_shardings_match_reference(arch, variant):
    """``batch_shardings`` of each mode's ``input_specs`` (the cache by
    ``cache_logical_axes``) at the variant's shapes, under the mode's
    rules, equal the reference's; the shapes given as ``input_specs``
    pairs, as bare shapes and (SMOKE) as numpy arrays alike."""
    cfg, jcfg = _cfgs(arch, variant)
    model, jmodel = _port_model(cfg), j_build_model(jcfg)
    table = configs.SMOKE_SHAPES if variant == "SMOKE" else configs.SHAPES
    modes = ("train",) if arch == "dlrm-paper" else ("train", "prefill", "decode")
    for mode in modes:
        shape = next(s for s in table.values() if s.mode == mode)
        rules = "TRAIN_RULES" if mode == "train" else "SERVE_RULES"
        ins = model.input_specs(shape.global_batch, shape.seq_len, mode)
        jins = jmodel.input_specs(shape.global_batch, shape.seq_len, mode)
        for name in MESHES:
            mesh = StubMesh(name)
            got = flatten(steps.batch_shardings(model, ins, getattr(psh, rules), mesh))
            want = flatten(j_batch_shardings(jmodel, jins, getattr(jsh, rules), mesh))
            assert list(got) == list(want)
            for k in want:
                _same(got[k], want[k])
            leaf = (lambda s: np.zeros(s, np.int8)) if variant == "SMOKE" else tuple
            bare = {k: ({ck: _shape_of(cv) for ck, cv in v.items()} if k == "cache"
                        else leaf(_shape_of(v))) for k, v in ins.items()}
            assert flatten(steps.batch_shardings(model, bare, getattr(psh, rules), mesh)) == got


@pytest.mark.parametrize("shape_name", list(configs.SMOKE_SHAPES))
@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS if a != "dlrm-paper"])
def test_make_step_specs_match_reference(arch, shape_name):
    """``make_step`` at SMOKE shapes on a (2, 2) mesh: the parameter specs
    by name (a stack's layers each their stacked leaf's spec less the
    "stack" axis) and the batch's, under the reference's default rules
    for the mode and profile; the expert leaves held whole on their
    expert slice where the MoE is expert-parallel."""
    mesh = StubMesh("2x2")
    bundle = steps.make_step(arch, shape_name, mesh, smoke=True, device="cpu")
    jcfg = jconfigs.get_smoke_config(arch)
    jmodel = j_build_model(jcfg)
    shape = jconfigs.SMOKE_SHAPES[shape_name]
    if shape.mode == "train":
        rules = jsh.FSDP_RULES if jcfg.sharding_profile == "fsdp" else jsh.TRAIN_RULES
    else:
        rules = jsh.SERVE_RULES
    want = flatten(j_partition_specs(jmodel.param_specs(), rules, mesh))
    stacks = bundle.model.stacks()
    for name, spec in bundle.in_specs[0].items():
        key, _, rest = name.partition(".")
        if key in stacks:
            ref_spec = want[f"{key}.{rest.partition('.')[2]}"]
            assert ref_spec[:1] in ((), (None,))
            _same(spec, psh.P(*tuple(ref_spec)[1:]))
        else:
            _same(spec, want[name])
    jins = jmodel.input_specs(shape.global_batch, shape.seq_len, shape.mode)
    got = flatten(bundle.in_specs[-1])
    for k, v in flatten(j_batch_shardings(jmodel, jins, rules, mesh)).items():
        _same(got[k], v)
    moe = getattr(jcfg, "moe", None)
    expected = moe is not None and not (jcfg.family == "hybrid" and jcfg.moe_period in (0, 1))
    assert bool(bundle.expert) == expected
    for k in bundle.expert:
        assert bundle.in_specs[0][k][0] == "model"


def test_make_train_step_sends_dlrm_to_the_sparse_step():
    mesh = StubMesh("2x2")
    cfg = configs.get_smoke_config("dlrm-paper")
    bundle = steps.make_train_step(cfg, mesh, 8, 0, device="cpu")
    assert isinstance(bundle.model, DLRM) and bundle.donate_argnums == (0, 1)
    assert steps.batch_axes(bundle.in_specs[2]) == ("data",)


def test_batch_split_over_model_refuses_an_expert_parallel_moe():
    """FSDP rules split the batch over "model" too; an expert-parallel
    MoE needs every "model" rank to hold the same tokens."""
    mesh = StubMesh("2x2")
    cfg = configs.get_smoke_config("deepseek-v2-236b")
    with pytest.raises(ValueError, match="split over 'model'"):
        steps.make_train_step(cfg, mesh, 8, 16, rules=psh.FSDP_RULES, device="cpu")


def test_serve_lm_example_on_the_cpu(capsys):
    """``examples/torch/serve_lm.py --device cpu`` serves the smoke LM;
    without ``--device`` it asks for the card."""
    import runpy
    from pathlib import Path

    main = runpy.run_path(str(Path(__file__).resolve().parents[1] / "examples" / "torch"
                              / "serve_lm.py"))["main"]
    assert main(["--device", "cpu"]) == 0
    assert "finite logits: True" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            main([])


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "jamba-1.5-large-398b"])
def test_remat_recomputes_under_the_forward_sharding_context(arch):
    """Autograd runs a CUDA graph's backward on the device's own thread,
    where the forward thread's sharding context is not set: a remat
    layer's recomputation must see the forward's context all the same,
    or an expert-parallel MoE recomputes as a one-device one.  Here the
    backward runs on another thread on the CPU; every ``moe_forward``
    call, forward and recomputation, sees the context."""
    import dataclasses
    import threading

    from repro_torch.distributed.context import current_context, sharding_context
    from repro_torch.models import moe as moe_lib

    cfg = dataclasses.replace(configs.get_smoke_config(arch), param_dtype=torch.float32,
                              compute_dtype=torch.float32, remat=True)
    model = build_model(cfg, device="cpu").init(0)
    seen, real = [], moe_lib.moe_forward

    def spy(*args, **kwargs):
        seen.append(current_context())
        return real(*args, **kwargs)

    tokens = torch.zeros((1, 16), dtype=torch.long)
    mesh = StubMesh("1x4")
    mesh.shape = {"data": 1, "model": 1}          # no expert parallelism: a plain run
    moe_lib.moe_forward = spy
    try:
        with sharding_context(mesh, psh.TRAIN_RULES):
            loss = model.loss({"tokens": tokens, "labels": tokens})
        n_forward = len(seen)
        worker = threading.Thread(target=loss.backward)
        worker.start()
        worker.join()
    finally:
        moe_lib.moe_forward = real
    assert n_forward > 0 and len(seen) == 2 * n_forward
    assert all(ctx is not None and ctx[0] is mesh for ctx in seen)
