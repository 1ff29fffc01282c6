"""The port's logical-axis sharding against the reference's.

``AxisRules.mesh_axes``, the three rule tables, ``logical_to_spec``,
``spec_tree`` and ``partition_specs`` of DLRM's parameter specs, in both
packages, on meshes (1, 4), (2, 4), (16, 16) and (2, 16, 16).  Both
``logical_to_spec``s read only ``mesh.axis_names`` and ``mesh.shape``, so
one stub mesh serves both and no device is needed.  Specs are compared as
tuples (the reference's ``PartitionSpec`` is one) and by their printed
form.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.common import partition_specs as j_partition_specs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as psh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import partition_specs  # noqa: E402


class StubMesh:
    """The two attributes ``logical_to_spec`` reads, and a coordinate for
    ``shard_tree``."""

    def __init__(self, shape, axes, coords=None):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self._coords = dict(zip(axes, coords or (0,) * len(axes)))

    def coord(self, axis):
        return self._coords[axis]


MESHES = {
    "1x4": ((1, 4), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
RULES = ["TRAIN_RULES", "FSDP_RULES", "SERVE_RULES"]
NAMES = sorted(set(jsh.TRAIN_RULES.rules) | set(jsh.FSDP_RULES.rules)
               | set(jsh.SERVE_RULES.rules)) + ["not_a_rule"]
DIMS = (1, 2, 4, 6, 7, 8, 16, 32, 42, 256, 512, 2_000_000)
MULTI = [
    ("batch", "seq", "heads", None),
    ("heads", "mlp"),
    ("embed", "mlp"),
    ("mlp", "embed"),
    ("expert", "vocab", None),
    ("batch", "kv_seq", "kv_heads", None),
    ("stack", "embed", "heads", None),
    ("batch", "seq_sp", "embed"),
    (None, None),
    (),
]


def _mesh(name):
    shape, axes = MESHES[name]
    return StubMesh(shape, axes)


def _same(port_spec, ref_spec):
    assert isinstance(port_spec, psh.P)
    assert tuple(port_spec) == tuple(ref_spec)
    assert repr(port_spec) == repr(ref_spec)


def test_rule_tables_equal_the_reference():
    for name in RULES:
        assert dict(getattr(psh, name).rules) == dict(getattr(jsh, name).rules), name


def test_partition_spec_prints_as_the_reference():
    for axes in [(), ("data",), ("data", None, "model"), (("pod", "data"), None)]:
        _same(psh.P(*axes), jsh.P(*axes))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rules", RULES)
def test_mesh_axes_and_single_names(rules, mesh_name):
    mesh = _mesh(mesh_name)
    pr, jr = getattr(psh, rules), getattr(jsh, rules)
    for name in NAMES:
        assert pr.mesh_axes(name) == jr.mesh_axes(name), name
        assert pr.mesh_axes(name, mesh) == jr.mesh_axes(name, mesh), name
        _same(psh.logical_to_spec((name,), pr, mesh), jsh.logical_to_spec((name,), jr, mesh))
        for dim in DIMS:                 # divisible and indivisible by each axis
            _same(psh.logical_to_spec((name,), pr, mesh, (dim,)),
                  jsh.logical_to_spec((name,), jr, mesh, (dim,)))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rules", RULES)
def test_multi_dim_specs(rules, mesh_name):
    """Axis reuse falls back to replication, prefixes degrade on shapes
    that do not divide, trailing Nones are dropped."""
    mesh = _mesh(mesh_name)
    pr, jr = getattr(psh, rules), getattr(jsh, rules)
    rng = np.random.default_rng(0)
    for logical in MULTI:
        _same(psh.logical_to_spec(logical, pr, mesh), jsh.logical_to_spec(logical, jr, mesh))
        for _ in range(8):
            shape = tuple(int(rng.choice(DIMS)) for _ in logical)
            _same(psh.logical_to_spec(logical, pr, mesh, shape),
                  jsh.logical_to_spec(logical, jr, mesh, shape))
    tree = {"a": ("batch", None), "b": {"c": ("embed", "mlp"), "d": ("vocab",)}}
    shapes = {"a": (64, 3), "b": {"c": (512, 1024), "d": (7,)}}
    for port_tree, ref_tree in ((psh.spec_tree(tree, pr, mesh), jsh.spec_tree(tree, jr, mesh)),
                                (psh.spec_tree(tree, pr, mesh, shapes),
                                 jsh.spec_tree(tree, jr, mesh, shapes))):
        _same(port_tree["a"], ref_tree["a"])
        _same(port_tree["b"]["c"], ref_tree["b"]["c"])
        _same(port_tree["b"]["d"], ref_tree["b"]["d"])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", ["smoke", "paper"])
def test_dlrm_partition_specs(arch, rules, mesh_name):
    """``partition_specs(DLRM.param_specs())``: the same logical axes and
    shapes, so the same specs (tables by table where the model axis
    divides the table count, else by vocab; MLPs FSDP over data)."""
    get = "get_smoke_config" if arch == "smoke" else "get_config"
    pcfg = getattr(configs, get)("dlrm-paper")
    jcfg = getattr(jconfigs, get)("dlrm-paper")
    mesh = _mesh(mesh_name)
    port_specs = build_model(pcfg, device="cpu", tables=False).param_specs()
    ref_specs = j_build_model(jcfg).param_specs()
    got = _leaves(partition_specs(port_specs, getattr(psh, rules), mesh))
    want = _leaves(j_partition_specs(ref_specs, getattr(jsh, rules), mesh))
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])
    p_leaves, j_leaves = _leaves(port_specs), _leaves(ref_specs)
    for k in j_leaves:
        assert p_leaves[k].logical == j_leaves[k].logical, k
        assert p_leaves[k].shape == j_leaves[k].shape, k


def test_param_spec_rejects_wrong_logical_rank():
    from repro_torch.models.common import ParamSpec

    with pytest.raises(ValueError):
        ParamSpec((4, 4), torch.float32, logical=("embed",))
    with pytest.raises(ValueError):
        partition_specs({"w": ParamSpec((4, 4), torch.float32)}, psh.TRAIN_RULES,
                        _mesh("1x4"))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_tree_takes_the_named_sharding_slice(mesh_name):
    """Each rank's slice, major-to-minor over a dimension's mesh axes (the
    order a NamedSharding lays shards out in), tiles the leaf exactly."""
    shape, axes = MESHES[mesh_name]
    spec = psh.P(tuple(a for a in axes if a != "model"), "model")
    n_rows = int(np.prod([s for s, a in zip(shape, axes) if a != "model"]))
    n_cols = dict(zip(axes, shape))["model"]
    leaf = np.arange(n_rows * 3 * n_cols * 2).reshape(n_rows * 3, n_cols * 2)
    seen = np.zeros(leaf.shape, bool)
    for coords in np.ndindex(*shape):
        mesh = StubMesh(shape, axes, coords)
        part = psh.shard_tree({"x": {"y": leaf}}, {"x": {"y": spec}}, mesh)["x"]["y"]
        c = dict(zip(axes, coords))
        row = 0
        for a in axes:
            if a != "model":
                row = row * mesh.shape[a] + c[a]
        np.testing.assert_array_equal(part, leaf[row * 3:(row + 1) * 3,
                                                 c["model"] * 2:(c["model"] + 1) * 2])
        seen[row * 3:(row + 1) * 3, c["model"] * 2:(c["model"] + 1) * 2] = True
    assert seen.all()
    with pytest.raises(ValueError):
        psh.shard_leaf(np.zeros((3, 5)), psh.P(None, "model"), StubMesh((1, 4), ("data", "model")))
