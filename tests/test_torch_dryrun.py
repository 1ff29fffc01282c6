"""The port's dry run (``repro_torch.launch.dryrun``): every supported
(arch, shape) cell at SMOKE size on a (2, 2) ``VirtualMesh`` on the
``meta`` device, and the dry run's arithmetic against the reference's
compiled steps.

The reference's ``analyze`` reads the compiled program of its step on a
one-device mesh with Auto axes (built as ``tests/torch_steps_ref.py``
builds them); the port's dry run traces the same SMOKE step on a (1, 1)
``VirtualMesh``.  Flops are held within 5%, with the measured gap
printed; where one package does work the other does not, the test takes
that term out by name and says which.  Bytes are not compared: XLA fuses
and eager mode does not, so the two count different traffic.
"""
import json

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import report as treport  # noqa: E402

CELLS = [(arch, shape) for arch in configs.ARCH_IDS for shape in configs.SMOKE_SHAPES
         if configs.cell_supported(arch, shape)[0]]
FLOPS_RTOL = 0.05


@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_cell_runs_at_smoke_size(arch, shape):
    rec = dryrun.run_cell(arch, shape, False, verbose=False, smoke=True, mesh_shape=(2, 2))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert rec["hlo_flops_per_device"] > 0 and rec["hlo_bytes_per_device"] > 0
    assert rec["unknown_trip_loops"] == 0
    mem = rec["memory_analysis"]
    assert mem["total_bytes_per_device"] == (mem["argument_bytes"] + mem["output_bytes"]
                                             + mem["temp_bytes"] - mem["alias_bytes"]) > 0
    # every product the flop counter sees is in the dot count; the kernels'
    # operations come on top
    kernel_flops = rec["hlo_flops_per_device"] - rec["flop_counter"]["flops_per_device"]
    assert kernel_flops >= 0
    assert (kernel_flops > 0) == bool(rec["kernel_calls"])
    mode = configs.SMOKE_SHAPES[shape].mode
    if mode == "train":
        # the gradients are averaged over "data" and the leaves gathered
        assert rec["collectives"].get("all-gather", 0) > 0
        assert rec["collectives"].get("all-reduce", 0) > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    if arch == "dlrm-paper":
        assert rec["device"] == "cpu" and "every mask slot set" in rec["note"]
    else:
        assert rec["device"] == "meta"


def _reference_cost(shape_name):
    import jax
    from jax.sharding import AxisType

    from repro.launch.hlo_analysis import analyze
    from repro.launch.steps import make_step

    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])
    return analyze(make_step("qwen3-8b", shape_name, mesh, smoke=True).lower().compile()
                   .as_text())


def _port(shape_name):
    tr = dryrun.trace_cell("qwen3-8b", shape_name, smoke=True, mesh_shape=(1, 1))[0]
    return tr, H.analyze(tr)


def test_train_flops_against_reference():
    """qwen3 SMOKE ``train_4k``.  The port checkpoints each chunk of the
    chunked cross-entropy and recomputes its logits in the backward
    (``models.layers._xent_chunk`` under an autograd node), which the
    reference's scan keeps instead; taken out by name, the rest equals
    the reference's count."""
    ref = _reference_cost("train_4k")
    tr, port = _port("train_4k")
    recompute = sum(r.flops for r in tr.ops
                    if r.site.startswith("models.layers._xent_chunk <"))
    gap = (port.flops - ref.flops) / ref.flops
    rest = (port.flops - recompute - ref.flops) / ref.flops
    print(f"train_4k flops: reference {ref.flops:.0f}, port {port.flops:.0f}, gap {gap:+.5f}; "
          f"less the cross-entropy's recomputed logits ({recompute:.0f}) {rest:+.5f}")
    assert recompute > 0
    assert abs(gap) < FLOPS_RTOL
    assert abs(rest) < FLOPS_RTOL


def test_prefill_flops_against_reference():
    """qwen3 SMOKE ``prefill_32k``.  The reference's XLA attention computes
    every (query, key) pair of its dense product, masked ones too (its
    ``dot`` term), where the port's ``flash_attention`` kernel counts the
    pairs the causal mask keeps; both attention terms are taken out by
    name and held to that relation exactly, and the rest is held within
    5%."""
    ref = _reference_cost("prefill_32k")
    tr, port = _port("prefill_32k")
    cfg, shape = configs.get_smoke_config("qwen3-8b"), configs.SMOKE_SHAPES["prefill_32k"]
    kernel = sum(r.flops for r in tr.ops if r.op == "kernel.flash_attention")
    assert tr.kernel_calls() == {"flash_attention": cfg.num_layers}
    s = shape.seq_len
    assert ref.dot_flops_by_meta["dot"] == kernel * 2 * s / (s + 1)
    gap = (port.flops - ref.flops) / ref.flops
    rest = (port.flops - kernel - (ref.flops - ref.dot_flops_by_meta["dot"])) / ref.flops
    print(f"prefill_32k flops: reference {ref.flops:.0f}, port {port.flops:.0f}, gap "
          f"{gap:+.5f}; less the attention terms {rest:+.5f}")
    assert abs(rest) < FLOPS_RTOL


def test_cli_writes_resumes_and_reports(tmp_path, capsys, monkeypatch):
    out = tmp_path / "dryrun_torch.jsonl"
    common = ["--smoke", "--mesh", "2x2", "--out", str(out)]
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k"] + common) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["shape"], r["status"]) for r in recs] == [
        ("qwen3-8b", "decode_32k", "ok")]
    monkeypatch.setattr("sys.argv", ["report", str(out)])
    capsys.readouterr()
    assert treport.main() == 0
    assert "| qwen3-8b | decode_32k | 2x2 |" in capsys.readouterr().out
