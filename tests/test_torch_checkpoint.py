"""The port's checkpoint store against the reference's.

The reference writes each shard with ``msgpack``; the port writes the
same msgpack subset itself (``repro_torch.checkpoint.wire``).  Here the
encoder is held byte for byte to ``msgpack.packb(..., use_bin_type=True)``
and each decoder reads the other's output; both packages'
``CheckpointManager``s write byte-identical shards for one ``dlrm-smoke``
state; each package's ``Trainer`` restores the other's checkpoint
(tensors bit-exact) and trains on within the trainer tolerance (rtol
1e-4: XLA and torch sum in other orders); the sparse path saves the MLPs
and their AdamW state only, the reference's key set; and
``examples/torch/train_dlrm_e2e.py`` runs on the CPU, held to the
reference example's own checks.  The reference store's three tests run
on the port's store as well.
"""
import os
import re
import runpy
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)
msgpack = pytest.importorskip("msgpack")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.train import embedding_cache as jcache  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree, wire  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models.dlrm import DLRMConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig, make_store_for_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = configs.get_smoke_config("dlrm-paper")
J_SMOKE = jconfigs.get_smoke_config("dlrm-paper")
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)    # losses over steps (ROADMAP Queue 3)


# -- the reference's tests/test_checkpoint.py on the port's store ------------------


def _state():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "e": torch.ones((4, 2), dtype=torch.bfloat16)},
        "opt": {"mu": {"w": torch.zeros((3, 4))}, "step": torch.tensor(7, dtype=torch.int32)},
    }


def test_roundtrip(tmp_path):
    s = _state()
    save_pytree(s, str(tmp_path / "ck"))
    out = load_pytree(s, str(tmp_path / "ck"))
    assert torch.equal(out["params"]["w"], s["params"]["w"])
    assert out["params"]["e"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["e"], s["params"]["e"])
    assert int(out["opt"]["step"]) == 7 and out["opt"]["step"].dtype == torch.int32


def test_manager_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    s = _state()
    for step in (10, 20, 30):
        mgr.save(step, s)
    assert mgr.all_steps() == [20, 30]
    assert mgr.latest_step() == 30
    step, out = mgr.restore(s)
    assert step == 30
    assert sorted(os.listdir(tmp_path)) == ["step_00000020", "step_00000030"]


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save(10, s)
    # simulate crash mid-save: dir without manifest
    os.makedirs(tmp_path / "step_00000020")
    assert mgr.latest_step() == 10
    step, _ = mgr.restore(s)
    assert step == 10


def test_missing_leaf_raises_and_empty_directory_has_no_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state())
    mgr.save(1, _state())
    with pytest.raises(KeyError):
        mgr.restore({"params": {"absent": torch.zeros(1)}})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"params": {"w": torch.zeros(4, 3)}})


# -- wire: the msgpack subset against msgpack ------------------------------------


def _plain(obj):
    """A decoded object with its memoryview bins as bytes."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    if isinstance(obj, memoryview):
        return obj.tobytes()
    return obj


def _agrees(obj):
    ours, theirs = wire.packb(obj), msgpack.packb(obj, use_bin_type=True)
    assert ours == theirs
    assert msgpack.unpackb(ours, raw=False) == _plain(obj)
    assert _plain(wire.unpackb(theirs)) == _plain(obj)


_EDGES = (0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536)


@pytest.mark.parametrize("n", _EDGES)
def test_wire_sizes_at_every_header_edge(n):
    _agrees("s" * n)
    _agrees("é" * (n // 2))                 # UTF-8: the header counts bytes
    _agrees(b"\x00" * n)
    _agrees(bytearray(b"\xff" * n))
    _agrees(list(range(min(n, 300))))
    _agrees([0] * n)
    _agrees({f"k{i}": i for i in range(n)})


def test_wire_ints_at_every_edge():
    edges = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, 2**64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    _agrees(edges)
    for x in edges:
        _agrees(x)
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            wire.packb(bad)


def test_wire_rejects_what_the_subset_lacks():
    for bad in (True, None, 1.5, (1, 2), {1: 2}, {"a": [False]}, np.int32(3)):
        with pytest.raises(TypeError):
            wire.packb(bad)
    with pytest.raises(ValueError, match="2\\^32"):
        wire._sized(lambda b: None, 1 << 32, 0, 0, (0xc4, 0xc5, 0xc6), "bin")
    for raw in (msgpack.packb(None), msgpack.packb(True), msgpack.packb(1.5),
                msgpack.packb({1: 2}), msgpack.packb(msgpack.ExtType(1, b"x"))):
        with pytest.raises(ValueError):
            wire.unpackb(raw)
    good = msgpack.packb({"a": b"xyz"}, use_bin_type=True)
    with pytest.raises(ValueError, match="truncated"):
        wire.unpackb(good[:-1])
    with pytest.raises(ValueError, match="after"):
        wire.unpackb(good + b"\x00")


def test_wire_writes_large_bins_from_their_own_buffer():
    """A bin goes to the file as the caller's buffer, not a copy."""
    a = np.arange(1 << 18, dtype=np.float32)
    writes = []

    class Sink:
        def write(self, b):
            writes.append(b)

    wire.pack({"data": memoryview(a.view(np.uint8))}, Sink())
    big = max(writes, key=len)
    assert isinstance(big, memoryview) and np.shares_memory(np.asarray(big), a)
    assert b"".join(bytes(w) for w in writes) == msgpack.packb(
        {"data": a.tobytes()}, use_bin_type=True)


def test_wire_matches_msgpack_on_random_payloads():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    leaf = st.one_of(st.integers(-2**63, 2**64 - 1), st.text(max_size=40),
                     st.binary(max_size=300))
    tree = st.recursive(leaf, lambda kids: st.one_of(
        st.lists(kids, max_size=20), st.dictionaries(st.text(max_size=12), kids, max_size=20)),
        max_leaves=60)

    @hyp.settings(max_examples=300, deadline=None, database=None)
    @hyp.given(tree)
    def check(obj):
        _agrees(obj)

    check()


# -- byte identity and cross restore ------------------------------------------------


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _shard(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "shard_0.msgpack"), "rb") as f:
        return f.read()


def test_dlrm_smoke_checkpoint_is_byte_identical_to_the_reference(tmp_path):
    jstate = JTrainer(J_SMOKE).init_state(0)
    tree = {"params": jstate["params"], "opt": jstate["opt"]}
    JManager(str(tmp_path / "ref")).save(5, tree)
    params = convert.dlrm_params_from_numpy(_np_tree(jstate["params"]))
    opt = convert.adamw_state_from_numpy(_np_tree(jstate["opt"]))
    CheckpointManager(str(tmp_path / "port")).save(5, Trainer.checkpoint_tree(params, opt))
    ref, port = _shard(tmp_path / "ref", 5), _shard(tmp_path / "port", 5)
    assert port == ref
    payload = msgpack.unpackb(ref, raw=False)
    assert len(payload) == 34 and list(payload) == sorted(payload)
    assert payload["['opt']['step']"] == {"dtype": "<i4", "shape": [], "data": b"\0" * 4}
    with open(tmp_path / "port" / "step_00000005" / "manifest.json") as f:
        assert f.read() == '{"step": 5, "complete": true}'


def _batches(cfg, n, bs=32, seed=0):
    # labels a fixed linear function of the dense features, as the
    # reference's tests/test_trainer.py makes them
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(1234).normal(0, 1, cfg.num_dense).astype(np.float32)
    shape = (bs, cfg.num_tables, cfg.max_ids_per_feature)
    out = []
    for _ in range(n):
        dense = rng.normal(0, 1, (bs, cfg.num_dense)).astype(np.float32)
        out.append({
            "dense": dense,
            "sparse_ids": rng.integers(0, cfg.vocab_per_table, shape).astype(np.int32),
            "sparse_mask": (rng.random(shape) < 0.7).astype(np.float32),
            "label": (dense @ w > 0).astype(np.float32),
        })
    return out


def _trainer(package, directory, steps):
    if package == "reference":
        opt = joptim.OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=40)
        return JTrainer(J_SMOKE, opt, JTrainerConfig(checkpoint_dir=str(directory),
                                                     checkpoint_every=3, max_steps=steps))
    opt = optim.OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=40)
    return Trainer(SMOKE, opt, TrainerConfig(checkpoint_dir=str(directory),
                                             checkpoint_every=3, max_steps=steps),
                   device="cpu")


def _flat(state):
    """A trainer's state -> {name: numpy} for params, mu, nu and the step."""
    if isinstance(state["params"], dict) and all(isinstance(v, torch.Tensor)
                                                  for v in state["params"].values()):
        out = {f"params.{k}": v.numpy() for k, v in state["params"].items()}
        for part in ("mu", "nu"):
            out.update({f"{part}.{k}": v.numpy() for k, v in state["opt"][part].items()})
    else:
        out = {f"params.{k}": v for k, v in convert._flatten(_np_tree(state["params"])).items()}
        for part in ("mu", "nu"):
            out.update({f"{part}.{k}": v for k, v in
                        convert._flatten(_np_tree(state["opt"][part])).items()})
    out["step"] = np.asarray(state["opt"]["step"])
    return out


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_trainer_restores_the_other_packages_checkpoint(tmp_path, writer, reader):
    """``writer`` trains 6 steps saving every 3; ``reader`` restores step 6
    bit-exact and trains 3 more, within rtol 1e-4 of ``writer``
    continuing from its own checkpoint."""
    batches = _batches(SMOKE, 9)
    first = _trainer(writer, tmp_path / "a", 6)
    state6 = first.fit(iter(batches[:6]))
    assert _trainer(writer, tmp_path / "a", 6).ckpt.all_steps() == [3, 6]
    shutil.copytree(tmp_path / "a", tmp_path / "b")

    cont = _trainer(writer, tmp_path / "a", 9)
    cont.fit(iter(batches[6:]))
    other = _trainer(reader, tmp_path / "b", 9)
    restored = other.maybe_restore(other.init_state(0))
    assert restored["step"] == 6
    want, got = _flat(state6), _flat(restored)
    assert sorted(got) == sorted(want) and len(got) == 34
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    out = other.fit(iter(batches[6:]))
    assert out["step"] == 9 and [m.step for m in other.history] == [7, 8, 9]
    assert [m.step for m in cont.history] == [7, 8, 9]
    np.testing.assert_allclose([m.loss for m in other.history],
                               [m.loss for m in cont.history], **GRAD_TOL)
    assert other.ckpt.all_steps() == [3, 6, 9]


def test_sparse_trainer_saves_the_reference_key_set(tmp_path):
    kw = dict(num_dense=6, num_tables=3, vocab_per_table=500, embed_dim=8,
              max_ids_per_feature=8, bottom_mlp=(16, 8), top_mlp=(32, 1))
    jcfg, pcfg = J_SMOKE.__class__(**kw), DLRMConfig(**kw)
    batches = _batches(pcfg, 2)
    store = dict(seed=3, admit_reads=2, host_dram_rows=64)
    jtr = JTrainer(jcfg, joptim.OptimizerConfig(),
                   JTrainerConfig(checkpoint_dir=str(tmp_path / "ref"), max_steps=2),
                   embedding_store=jcache.make_store_for_model(jcfg, 64, **store))
    jtr.fit(iter(batches))
    ptr = Trainer(pcfg, optim.OptimizerConfig(),
                  TrainerConfig(checkpoint_dir=str(tmp_path / "port"), max_steps=2),
                  embedding_store=make_store_for_model(pcfg, 64, device="cpu", **store),
                  device="cpu")
    ptr.fit(iter(batches))
    ref = msgpack.unpackb(_shard(tmp_path / "ref", 2), raw=False)
    port = msgpack.unpackb(_shard(tmp_path / "port", 2), raw=False)
    assert list(port) == list(ref)
    assert not any("tables" in k for k in ref) and len(ref) == 3 * 8 + 1
    for k in ref:
        assert (port[k]["dtype"], port[k]["shape"]) == (ref[k]["dtype"], ref[k]["shape"])


# -- the CLI and the example ----------------------------------------------------------


def test_train_cli_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    made = []

    class Recording(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(ptrain, "Trainer", Recording)
    ck = str(tmp_path / "ck")
    assert ptrain.main(["--smoke", "--steps", "20", "--device", "cpu",
                        "--checkpoint-dir", ck]) == 0
    assert made[0].cfg.checkpoint_every == 10
    assert CheckpointManager(ck).all_steps() == [10, 20]
    ptrain.main(["--smoke", "--steps", "24", "--device", "cpu", "--checkpoint-dir", ck,
                 "--resume"])
    assert [m.step for m in made[1].history] == [21, 22, 23, 24]
    assert CheckpointManager(ck).all_steps() == [10, 20, 24]
    assert "steps=24" in capsys.readouterr().out


def test_train_dlrm_e2e_example_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The reference example's own checks (resumed past a quarter of the
    steps, the loss fell), and its temporary directory removed."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    main = runpy.run_path(str(ROOT / "examples" / "torch" / "train_dlrm_e2e.py"))["main"]
    assert main(["--device", "cpu", "--steps", "8"]) == 0
    text = capsys.readouterr().out
    assert "DLRM params: 102.6M" in text
    assert "phase 1 done at step 4" in text
    assert re.search(r"resumed at step 5, finished at 8", text)
    first, last = map(float, re.search(r"loss: (\S+) -> (\S+)", text).groups())
    assert last < first
    assert os.listdir(tmp_path) == []
