"""The port's op-trace analyzer, roofline and kernel work counts
(``repro_torch.launch.hlo_analysis``, ``roofline``, ``debug_hlo``,
``report``, ``mesh.VirtualMesh``) against the reference's
``repro.launch`` counterparts and closed forms.

The reference reads its counts from compiled HLO text; the port from the
op trace a step leaves under a ``TorchDispatchMode``, eagerly: no loop
has a trip count to miss, and nothing is fused, so bytes are compared
with closed forms of the eager ops, not with XLA's.
"""
import json

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import debug_hlo, hlo_analysis as H, roofline as rl  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import report as treport  # noqa: E402


# ---------------------------------------------------------------------------
# counterparts of tests/test_hlo_analysis.py
# ---------------------------------------------------------------------------

def test_layer_stack_flops():
    """Ten 64 x 64 layers count 2 * 64^3 * 10 flops (the reference's scan
    over ten layers; eager mode runs each)."""
    x = torch.zeros((64, 64))
    w = torch.zeros((10, 64, 64))

    def f(x, w):
        for i in range(w.shape[0]):
            x = torch.tanh(x @ w[i])
        return x

    cost = H.analyze(H.trace(f, x, w))
    want = 2 * 64 ** 3 * 10
    assert abs(cost.flops - want) / want < 0.01
    assert cost.unknown_trip_loops == 0


def test_nested_loop_flops():
    """Four outer by five inner 32 x 32 layers, as the reference's nested
    scans, count each product once per trip."""
    x = torch.zeros((32, 32))
    w = torch.zeros((4, 32, 32))

    def f(x, w):
        for i in range(4):
            for _ in range(5):
                x = torch.tanh(x @ w[i])
        return x

    assert H.analyze(H.trace(f, x, w)).flops == 2 * 32 ** 3 * 4 * 5


M, K, HID, N = 128, 256, 512, 64


def _g(x, w1, w2):
    h = torch.relu(x @ w1)
    return torch.autograd.grad(torch.sum(h @ w2), (w1, w2))


def _g_args():
    x = torch.zeros((M, K))
    w1 = torch.zeros((K, HID), requires_grad=True)
    w2 = torch.zeros((HID, N), requires_grad=True)
    return x, w1, w2


def test_matches_flop_counter_on_loop_free_module():
    """The gradient of sum(relu(x @ w1) @ w2): flops within 2% of
    ``FlopCounterMode``; bytes equal to the closed form of its eager ops
    (each op's operands read and result written, views free)."""
    from torch.utils.flop_counter import FlopCounterMode

    args = _g_args()
    cost = H.analyze(H.trace(_g, *args))
    with FlopCounterMode(display=False) as fc:
        _g(*args)
    assert abs(cost.flops - fc.get_total_flops()) / fc.get_total_flops() < 0.02
    f = 4
    m, k, h, n = M, K, HID, N
    closed = f * (
        (m * k + k * h + m * h)          # x @ w1
        + 2 * m * h                      # relu
        + (m * h + h * n + m * n)        # h @ w2
        + (m * n + 1)                    # sum
        + 2                              # ones_like of the scalar loss
        + (h * m + m * n + h * n)        # dw2 = h^T g
        + (m * n + n * h + m * h)        # dh = g w2^T
        + 3 * m * h                      # relu's backward
        + (k * m + m * h + k * h))       # dw1 = x^T dh
    assert cost.bytes_accessed == closed


def test_matches_reference_analyzer():
    """The reference's ``analyze`` of the compiled gradient (its
    ``tests/test_hlo_analysis.py`` function) and the port's analyzer of
    the same gradient agree within 2% on flops, once one term is taken
    out by name: the forward product ``h @ w2``, whose value only feeds
    the loss, which ``jax.grad`` does not return, so XLA drops it as dead
    code, while eager autograd computes it.  The gap is printed both
    ways."""
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze as j_analyze

    def g(x, w1, w2):
        h = jax.nn.relu(x @ w1)
        return jnp.sum(h @ w2)

    c = jax.jit(jax.grad(g, argnums=(1, 2))).lower(
        jnp.zeros((M, K)), jnp.zeros((K, HID)), jnp.zeros((HID, N))).compile()
    ref = j_analyze(c.as_text()).flops
    tr = H.trace(_g, *_g_args())
    mine = H.analyze(tr).flops
    dead = [r for r in tr.ops if r.op == "aten.mm.default" and "<" not in r.site
            and r.outputs == (("float32", (M, N)),)]
    assert len(dead) == 1 and dead[0].flops == 2 * M * HID * N
    print(f"flops: reference {ref:.0f}, port {mine:.0f} (gap {(mine - ref) / ref:+.4f}); "
          f"less the dead forward product {mine - dead[0].flops:.0f} "
          f"(gap {(mine - dead[0].flops - ref) / ref:+.4f})")
    assert abs(mine - dead[0].flops - ref) / ref < 0.02


def test_live_bytes_peak():
    """The peak of the storages a step makes, above its arguments; views
    share their base's storage; outputs that are arguments are aliases."""
    a0 = torch.zeros(1000)

    def f(a):
        b = a + 1                  # 4000 B
        c = b.view(10, 100) * 2    # 4000 B (the view is free)
        del b
        d = c.sum()                # 4 B
        a.add_(1)                  # in place: no new storage
        return a, d

    tr = H.trace(f, a0)
    assert tr.memory == {"argument": 4000, "output": 4004, "alias": 4000, "peak_live": 8000}
    mem = H.memory_analysis(tr)
    assert mem["temp_bytes"] == 8000 - 4
    assert mem["total_bytes_per_device"] == 4000 + 4004 + (8000 - 4) - 4000


def test_debug_hlo_totals_equal_analyze():
    tr = H.trace(_g, *_g_args())
    b, w, f = debug_hlo.attribute(tr)
    cost = H.analyze(tr)
    assert sum(b.values()) == cost.bytes_accessed
    assert sum(f.values()) == cost.flops
    assert sum(w.values()) == cost.wire_bytes == 0


def test_debug_hlo_wire_by_collective():
    mesh = meshlib.VirtualMesh((2, 4), ("data", "model"))
    x = torch.zeros((8, 16), device="meta")
    tr = H.trace(lambda: (mesh.all_gather(x, "model"), mesh.all_reduce(x, ("data", "model"))))
    b, w, f = debug_hlo.attribute(tr)
    assert sum(w.values()) == H.analyze(tr).wire_bytes > 0


# ---------------------------------------------------------------------------
# the virtual mesh and the collectives
# ---------------------------------------------------------------------------

def test_virtual_mesh_collectives():
    """Results of the right shape, axes of size 1 skipped, each collective
    recorded with its group and whether the group lies within a node."""
    mesh = meshlib.VirtualMesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh.device.type == "meta" and mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert [mesh.coord(a) for a in mesh.axis_names] == [0, 0, 0]
    x = torch.zeros((4, 6), dtype=torch.bfloat16, device="meta")
    with meshlib.record_collectives() as log:
        g = mesh.all_gather(x, ("data", "model"), dim=1)
        r = mesh.all_reduce(x, "pod")
        mesh.barrier()
    assert g.shape == (4, 6 * 256) and r.shape == x.shape
    assert [(c.kind, c.axis, c.group, c.nbytes, c.node_local) for c in log] == [
        ("all-gather", "model", 16, 4 * 96 * 2, False),       # 16 ranks: two nodes
        ("all-gather", "data", 16, 4 * 1536 * 2, False),      # stride 16
        ("all-reduce", "pod", 2, 4 * 6 * 2, False),
    ]
    small = meshlib.VirtualMesh((4, 2, 1), ("pod", "data", "model"), coord=(3, 1, 0),
                                device="cpu")
    t = torch.arange(6.0).reshape(2, 3)
    with meshlib.record_collectives() as log:
        assert torch.equal(small.all_gather(t, "data"), torch.cat([t, t]))
        assert torch.equal(small.all_reduce(t, "model"), t)      # size 1: skipped
    assert [(c.kind, c.group, c.node_local) for c in log] == [("all-gather", 2, True)]
    with pytest.raises(ValueError):
        meshlib.VirtualMesh((2, 2), ("data", "model"), coord=(2, 0))


def test_parse_collectives_and_link_rates():
    log = [meshlib.Collective("all-gather", 1000, "model", 4, True),
           meshlib.Collective("all-reduce", 800, "data", 16, False),
           meshlib.Collective("all-reduce", 100, "model", 1, True)]
    s = rl.parse_collectives(log)
    assert s.counts == {"all-gather": 1, "all-reduce": 2}
    assert s.result_bytes == {"all-gather": 1000, "all-reduce": 900}
    intra = rl._collective_wire("all-gather", 1000, 4)
    inter = rl._collective_wire("all-reduce", 800, 16)
    assert s.wire_bytes_per_device == intra + inter and s.inter_node_wire_bytes == inter
    t = rl.RooflineTerms(0.0, 0.0, s.wire_bytes_per_device, 1,
                         inter_node_wire_bytes=s.inter_node_wire_bytes)
    assert t.collective_s == pytest.approx(intra / meshlib.NVLINK_BW
                                           + inter / meshlib.INTER_NODE_BW, rel=1e-12)


# ---------------------------------------------------------------------------
# shared formulas against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                  "collective-permute", "all-gather-start", "send"])
def test_collective_wire_equals_reference(kind):
    from repro.launch.hlo_analysis import _collective_wire as j_wire

    for g in (1, 2, 4, 16):
        for nbytes in (0, 7, 4096, 123_456_789):
            assert rl._collective_wire(kind, nbytes, g) == j_wire(kind, nbytes, g)


@pytest.mark.parametrize("link", ["nvlink", "inter_node"])
def test_roofline_terms_equal_reference(link, monkeypatch):
    """With the reference's TPU constants swapped for the H100's (its one
    link rate for NVLink's, or the inter-node port's when every group
    spans nodes), ``RooflineTerms`` gives the reference's terms."""
    from repro.launch import mesh as j_mesh
    from repro.launch import roofline as j_rl

    rate = meshlib.NVLINK_BW if link == "nvlink" else meshlib.INTER_NODE_BW
    monkeypatch.setattr(j_mesh, "PEAK_FLOPS_BF16", meshlib.PEAK_FLOPS_BF16)
    monkeypatch.setattr(j_mesh, "HBM_BW", meshlib.HBM_BW)
    monkeypatch.setattr(j_mesh, "ICI_BW", rate)
    cases = [(3.1e17, 2.2e15, 4.5e10, 256, 1.0e17), (1e12, 9e13, 0.0, 1, 0.0),
             (5e15, 1e12, 7e11, 512, 4e15), (0.0, 0.0, 0.0, 4, 0.0)]
    for flops, hbm, wire, chips, model in cases:
        mine = rl.RooflineTerms(flops, hbm, wire, chips, model,
                                inter_node_wire_bytes=wire if link == "inter_node" else 0.0)
        theirs = j_rl.RooflineTerms(flops, hbm, wire, chips, model)
        got, want = mine.to_dict(), theirs.to_dict()
        for key, v in want.items():
            if isinstance(v, float):
                assert got[key] == pytest.approx(v, rel=1e-12, abs=0.0), key
            else:
                assert got[key] == v, key


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_flops_estimates_equal_reference(arch):
    """``model_flops_estimate`` and ``attention_flops_estimate`` of every
    arch at every shape equal the reference's."""
    from repro import configs as j_configs
    from repro.launch import roofline as j_rl

    for name, shape in configs.SHAPES.items():
        j_shape = j_configs.SHAPES[name]
        cfg, j_cfg = configs.get_config(arch), j_configs.get_config(arch)
        assert rl.model_flops_estimate(cfg, shape) == j_rl.model_flops_estimate(j_cfg, j_shape)
        assert (rl.attention_flops_estimate(cfg, shape)
                == j_rl.attention_flops_estimate(j_cfg, j_shape))


# ---------------------------------------------------------------------------
# the kernels' work
# ---------------------------------------------------------------------------

def _kernel_cases():
    """Each kernel's op on small CPU operands with valid values:
    (name, args, kwargs)."""
    g = torch.Generator().manual_seed(3)
    i32 = torch.int32
    ids = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, 4), generator=g, dtype=torch.int64).to(i32)
    codes = torch.tensor([kref.OP_SIGRID_HASH, kref.OP_CLAMP, kref.OP_BUCKETIZE_F,
                          kref.OP_IDENTITY], dtype=i32)
    p0 = torch.tensor([7, -5, 0, 0], dtype=i32)
    p1 = torch.tensor([1000, 5, 0, 0], dtype=i32)
    borders = torch.sort(torch.randn((4, 3), generator=g), dim=1).values
    src = torch.randint(0, 2 ** 31 - 1, (6, 128), generator=g, dtype=torch.int64).to(i32)
    idx = torch.randint(0, 6 * 128 - 1, (2, 128), generator=g, dtype=torch.int64).to(i32)
    shift = torch.randint(0, 32, (2, 128), generator=g, dtype=torch.int64).to(i32)
    table = torch.randn((20, 8), generator=g)
    bag_ids = torch.randperm(20, generator=g)[:15].reshape(5, 3).to(i32)   # distinct rows
    q = torch.randn((1, 4, 16, 8), generator=g)
    kv = torch.randn((1, 2, 16, 8), generator=g)
    x = torch.randn((1, 8, 2, 4), generator=g)
    dt = torch.rand((1, 8, 2), generator=g) + 0.1
    bc = torch.randn((1, 8, 1, 4), generator=g)
    return [
        ("fused_transform", (ids, codes, p0, p1, borders), {}),
        ("xor_decrypt", (src,), {}),
        ("dense_unpack", (src[:3, :2].contiguous(), src[:3, :64].contiguous()), {}),
        ("ragged_gather", (src, idx, shift), {}),
        ("embedding_bag", (table, bag_ids, torch.ones((5, 3))), {"mode": "mean"}),
        ("flash_attention", (q, kv, kv), {"causal": True}),
        ("ssd_chunk_forward", (x, dt, -torch.rand(2, generator=g), bc, bc), {"chunk": 4}),
        ("sigrid_hash", (ids, 1, 100), {}),
        ("bucketize", (torch.randn((4, 8), generator=g), borders[0].contiguous()), {}),
        ("rowwise_adagrad_", (table, torch.rand(20, generator=g), bag_ids,
                              torch.rand((5, 3), generator=g) + 0.5,
                              torch.randn((5, 8), generator=g), 0.1), {}),
    ]


def _to_meta(name, args):
    """The operands on ``meta``; fused_transform's op codes stay on the CPU:
    its work depends on their values, which are the host's plan."""
    out = []
    for i, a in enumerate(args):
        keep = name == "fused_transform" and i == 1
        out.append(a.to("meta") if isinstance(a, torch.Tensor) and not keep else a)
    return tuple(out)


@pytest.mark.parametrize("case", _kernel_cases(), ids=lambda c: c[0])
def test_kernel_counted_alike_on_cpu_and_meta(case):
    """The analyzer counts one kernel op with ``kernel_work``'s operations
    and bytes, none of its plain version's ops, the same on ``cpu`` and on
    ``meta``; on ``meta`` the op returns an empty result of the plain
    version's shape and dtype."""
    name, args, kw = case
    assert name in rl.KERNELS
    fn = getattr(ops, name)
    costs, results = {}, {}
    for device, a in (("cpu", args), ("meta", _to_meta(name, args))):
        tr = H.trace(lambda a=a: fn(*a, **kw))
        assert tr.kernel_calls() == {name: 1}
        assert [r.op for r in tr.ops] == [f"kernel.{name}"]
        c = H.analyze(tr)
        costs[device] = (c.flops, c.bytes_accessed)
        results[device] = tr.result
    assert costs["cpu"] == costs["meta"] == tuple(map(float, rl.kernel_work(name, *args, **kw)))
    want = results["cpu"] if isinstance(results["cpu"], tuple) else (results["cpu"],)
    got = results["meta"] if isinstance(results["meta"], tuple) else (results["meta"],)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)


def test_bag_rows_on_meta_are_the_most_a_call_can_read():
    table = torch.zeros((20, 8))
    ids = torch.tensor([[1, 1, 2], [2, 3, 1]], dtype=torch.int32)
    mask = torch.ones((2, 3))
    cpu = rl.kernel_work("embedding_bag", table, ids, mask)
    meta = rl.kernel_work("embedding_bag", *(t.to("meta") for t in (table, ids, mask)))
    assert cpu[0] == meta[0]
    assert meta[1] - cpu[1] == (6 - 3) * 8 * 4


# The bounds PERF.md §6 records (us) at the operands they were taken at.
_E = dict(device="meta")


def _bound_cases():
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    e = lambda *s, dtype=i32: torch.empty(s, dtype=dtype, **_E)  # noqa: E731
    bag_ids = (torch.arange(2544 * 32) % 1893).reshape(2544, 32).to(i32)   # 1893 rows read
    wave1_codes = torch.full((171,), kref.OP_BUCKETIZE_F, dtype=i32)
    wave1_codes[::2] = kref.OP_CLAMP_F
    return [
        ("xor_decrypt", [((e(1453, 128),), {})], 0.444),
        ("dense_unpack", [((e(504, 16), e(504, 478)), {})], 0.605),
        ("ragged_gather", [((e(1962, 128), e(1959, 128), e(1959, 128)), {})], 1.198),
        ("fused_transform", [    # two waves a stripe, their bounds added
            ((e(32, 8192), torch.full((32,), kref.OP_SIGRID_HASH, dtype=i32), e(32), e(32),
              e(32, 1, dtype=f32)), {"features_major": True}),
            ((e(171, 512), wave1_codes, e(171), e(171), e(171, 63, dtype=f32)),
             {"features_major": True})], 0.626 + 0.223),
        ("embedding_bag", [((e(43008, 128, dtype=f32), bag_ids, e(2544, 32, dtype=f32)),
                            {})], 0.873),
        ("sigrid_hash", [((e(512, 1344), 1, 2_000_000), {})], 1.643),
        ("bucketize", [((e(512, 504, dtype=f32), e(63, dtype=f32)), {})], 0.616),
        ("flash_attention", [((e(4, 32, 1024, 128, dtype=bf), e(4, 8, 1024, 128, dtype=bf),
                               e(4, 8, 1024, 128, dtype=bf)), {"causal": True})], 34.776),
        ("flash_attention", [((e(4, 128, 1024, 192, dtype=bf),) * 3, {"causal": True})],
         240.390),
        ("flash_attention", [((e(4, 16, 1024, 64, dtype=bf),) * 3, {"causal": False})], 17.371),
        ("flash_attention", [((e(4, 16, 128, 64, dtype=bf), e(4, 16, 1024, 64, dtype=bf),
                               e(4, 16, 1024, 64, dtype=bf)), {"causal": False})], 5.634),
        ("flash_attention", [((e(4, 64, 1024, 128, dtype=bf), e(4, 8, 1024, 128, dtype=bf),
                               e(4, 8, 1024, 128, dtype=bf)), {"causal": True})], 69.552),
        ("ssd_chunk_forward", [((e(4, 1024, 80, 64, dtype=bf), e(4, 1024, 80, dtype=f32),
                                 e(80, dtype=f32), e(4, 1024, 1, 128, dtype=bf),
                                 e(4, 1024, 1, 128, dtype=bf)), {"chunk": 256})], 29.188),
        ("ssd_chunk_forward", [((e(4, 1024, 256, 64, dtype=bf), e(4, 1024, 256, dtype=f32),
                                 e(256, dtype=f32), e(4, 1024, 1, 16, dtype=bf),
                                 e(4, 1024, 1, 16, dtype=bf)), {"chunk": 256})], 82.713),
    ]


@pytest.mark.parametrize("case", _bound_cases(),
                         ids=lambda c: f"{c[0]}-{c[2]:.3f}")
def test_kernel_bound_gives_back_recorded_bounds(case):
    name, calls, recorded_us = case
    us = sum(rl.kernel_bound(name, *a, **kw)[0] for a, kw in calls) * 1e3
    assert abs(us - recorded_us) / recorded_us < 1e-3, (name, us, recorded_us)


def test_kernel_bound_reports_its_side():
    q = torch.empty((4, 32, 1024, 128), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((4, 8, 1024, 128), dtype=torch.bfloat16, device="meta")
    ms, by, flops, nbytes = rl.kernel_bound("flash_attention", q, kv, kv, causal=True)
    assert (by, flops, nbytes) == ("operations", 34_393_292_800, 83_886_080)
    assert ms == flops / meshlib.PEAK_FLOPS_BF16 * 1e3
    with pytest.raises(KeyError):
        rl.kernel_work("matmul", q)


# ---------------------------------------------------------------------------
# report.py renders both packages' records alike
# ---------------------------------------------------------------------------

def _records():
    roof = rl.RooflineTerms(3.2e17, 1.1e16, 2.0e10, 256, 1.5e17).to_dict()
    ok = {"arch": "qwen3-8b", "shape": "train_4k", "mesh": "16x16", "multi_pod": False,
          "chips": 256, "status": "ok", "roofline": roof,
          "memory_analysis": {"total_bytes_per_device": 38_062_872_272}}
    ok2 = dict(ok, shape="prefill_32k", roofline=rl.RooflineTerms(
        1.5e15, 9e14, 1.5e10, 256, 1.0e15).to_dict())
    pod = dict(ok, mesh="2x16x16", multi_pod=True, chips=512)
    return [ok, ok2, pod,
            {"arch": "dlrm-paper", "shape": "decode_32k", "multi_pod": False,
             "status": "skipped", "reason": "DLRM has no sequence/KV-cache serving shapes"},
            {"arch": "llama3-405b", "shape": "train_4k", "multi_pod": False, "status": "error",
             "error": "RuntimeError: something"},
            dict(ok, shape="decode_32k", status="running")]


@pytest.mark.parametrize("single_pod_only", [False, True])
def test_report_renders_like_reference(tmp_path, capsys, monkeypatch, single_pod_only):
    from repro.launch import report as j_report

    path = tmp_path / "dryrun.jsonl"
    with open(path, "w") as f:
        for r in _records():
            f.write(json.dumps(r) + "\n")
        f.write("not json\n")
    argv = ["report", str(path)] + (["--single-pod-only"] if single_pod_only else [])
    texts = []
    for mod in (treport, j_report):
        monkeypatch.setattr("sys.argv", argv)
        assert mod.main() == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]
    assert "| qwen3-8b | train_4k | 16x16 |" in texts[0]
    assert ("2x16x16" in texts[0]) != single_pod_only
