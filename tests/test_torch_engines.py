"""The port's engines against the reference package, bit for bit.

``TorchEngine(device="cpu")`` is held against the reference's
``PallasEngine`` (Pallas kernel in interpret mode, and the XLA oracle)
and ``NumpyEngine``; ``TorchDecodeEngine(device="cpu")`` against the
reference's ``PallasDecodeEngine`` and ``NumpyDecodeEngine``, per stripe
and through ``TableReader(double_buffer=True)`` over codecs x encodings x
projections.  Inputs are made with numpy from a seed and handed to both
packages (the port's copies of the data path make the same bytes).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro.core import dwrf as jdwrf  # noqa: E402
from repro.core import transforms as jT  # noqa: E402
from repro.core.datagen import DataGenConfig as JDataGenConfig  # noqa: E402
from repro.core.datagen import generate_partition as j_generate  # noqa: E402
from repro.core.decode import NumpyDecodeEngine as JNumpyDecode  # noqa: E402
from repro.core.decode import PallasDecodeEngine  # noqa: E402
from repro.core.engine import NumpyEngine as JNumpyEngine  # noqa: E402
from repro.core.engine import PallasEngine  # noqa: E402
from repro.core.reader import TableReader as JTableReader  # noqa: E402
from repro.core.schema import ColumnBatch as JColumnBatch  # noqa: E402
from repro.core.schema import SparseColumn as JSparseColumn  # noqa: E402
from repro.core.schema import make_schema as j_make_schema  # noqa: E402
from repro.core.warehouse import Warehouse as JWarehouse  # noqa: E402
from repro_torch.convert import column_batch_from_numpy  # noqa: E402
from repro_torch.core import dwrf  # noqa: E402
from repro_torch.core import transforms as T  # noqa: E402
from repro_torch.core.datagen import DataGenConfig  # noqa: E402
from repro_torch.core.decode import (  # noqa: E402
    DECODE_ENGINES,
    NumpyDecodeEngine,
    TorchDecodeEngine,
    make_decode_engine,
)
from repro_torch.core.engine import (  # noqa: E402
    ENGINES,
    NumpyEngine,
    TorchEngine,
    make_engine,
)
from repro_torch.core.reader import TableReader  # noqa: E402
from repro_torch.core.schema import SparseColumn, make_schema  # noqa: E402
from repro_torch.core.warehouse import Warehouse  # noqa: E402


# -- helpers -----------------------------------------------------------------


def _bits(a):
    return (a.view(np.int32) if a.dtype == np.float32 else a).tobytes()


def _assert_column_identical(a, b, key=""):
    """Byte equality of a port column and a reference column (NaN bit
    patterns and dtypes included)."""
    if hasattr(a, "offsets"):
        assert hasattr(b, "offsets"), key
        for x, y in ((a.offsets, b.offsets), (a.values, b.values)):
            assert x.dtype == y.dtype and _bits(x) == _bits(y), key
        assert (a.scores is None) == (b.scores is None), key
        if a.scores is not None:
            assert _bits(a.scores) == _bits(b.scores), key
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert _bits(np.ascontiguousarray(a)) == _bits(np.ascontiguousarray(b)), key


def _assert_batches_identical(a, b):
    assert a.num_rows == b.num_rows
    assert list(a.dense) == list(b.dense)
    assert list(a.sparse) == list(b.sparse)
    for f in a.dense:
        _assert_column_identical(a.dense[f], b.dense[f], key=f"dense {f}")
    for f in a.sparse:
        _assert_column_identical(a.sparse[f], b.sparse[f], key=f"sparse {f}")
    assert (a.labels is None) == (b.labels is None)
    if a.labels is not None:
        assert _bits(a.labels) == _bits(b.labels)


def _to_port(batch):
    """A reference ColumnBatch as the port's, through convert.py."""
    return column_batch_from_numpy(
        batch.num_rows, dict(batch.dense),
        {f: (c.offsets, c.values, c.scores) for f, c in batch.sparse.items()},
        batch.labels,
    )


def _col(lists, scores=None):
    lengths = [len(x) for x in lists]
    off = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    vals = (np.concatenate([np.asarray(x, np.int64) for x in lists])
            if lists else np.zeros(0, np.int64))
    sc = (np.concatenate([np.asarray(s, np.float32) for s in scores])
          if scores else None)
    return JSparseColumn(offsets=off, values=vals, scores=sc)


def _run_transform_engines(specs, jbatch, row_quantum=512):
    """Run the reference engines and the port's engines over the same
    batch; every output must be byte-identical across all of them."""
    jpipe = jT.TransformPipeline(list(specs))
    pipe = T.TransformPipeline([
        T.TransformSpec(s.op, s.inputs, s.output, s.params) for s in specs
    ])
    batch = _to_port(jbatch)
    ref_envs = [
        JNumpyEngine(jpipe).run(jbatch),
        PallasEngine(jpipe, use_pallas=True, row_quantum=row_quantum).run(jbatch),
    ]
    te = TorchEngine(pipe, device="cpu", row_quantum=row_quantum)
    envs = [NumpyEngine(pipe).run(batch), te.run(batch)]
    for env in envs + ref_envs[1:]:
        assert set(env) == set(ref_envs[0])
        for k in ref_envs[0]:
            _assert_column_identical(env[k], ref_envs[0][k], key=k)
    return te


ADVERSARIAL_IDS = [
    [-1, -7, 0, 7],
    [2 ** 31 - 1, -(2 ** 31), 1],
    [],
    [2 ** 40 + 3, -(2 ** 40)],   # beyond int32: 32-bit truncation
    [],
]


# -- transform engine ---------------------------------------------------------


@pytest.mark.parametrize("salt,max_value", [
    (0, 1), (13, 2), (2 ** 31 - 1, 997), (5, 2 ** 31 - 1),
])
def test_sigrid_hash_engine(salt, max_value):
    batch = JColumnBatch(num_rows=5, dense={}, sparse={0: _col(ADVERSARIAL_IDS)})
    specs = [jT.TransformSpec(
        "SigridHash", ("f0",), "out", (("salt", salt), ("max_value", max_value)),
    )]
    te = _run_transform_engines(specs, batch)
    assert te.stats.fused_features == 1 and te.stats.kernel_launches == 1


@pytest.mark.parametrize("m", [1, 5, 2 ** 31 - 1])
def test_positive_modulus_engine(m):
    lists = [[-7, 7, -1], [-(2 ** 31), 2 ** 31 - 1], []]
    batch = JColumnBatch(num_rows=3, dense={}, sparse={0: _col(lists)})
    specs = [jT.TransformSpec("PositiveModulus", ("f0",), "out", (("m", m),))]
    assert _run_transform_engines(specs, batch).stats.fused_features == 1


def test_positive_modulus_int64_demotes():
    batch = JColumnBatch(num_rows=2, dense={}, sparse={0: _col([[2 ** 40, -3], [5]])})
    specs = [jT.TransformSpec("PositiveModulus", ("f0",), "out", (("m", 97),))]
    te = _run_transform_engines(specs, batch)
    assert te.stats.demoted_features == 1 and te.stats.fused_features == 0


@pytest.mark.parametrize("lo,hi", [(-10.0, 10.0), (0.5, 0.5), (-2.0 ** 100, 2.0 ** 100)])
def test_clamp_engine(lo, hi):
    vals = np.array([np.nan, -np.inf, np.inf, 0.0, -0.0, -10.0, 10.0, 9.999999],
                    np.float32)
    batch = JColumnBatch(num_rows=len(vals), dense={0: vals}, sparse={})
    specs = [jT.TransformSpec("Clamp", ("f0",), "out", (("lo", lo), ("hi", hi)))]
    assert _run_transform_engines(specs, batch).stats.fused_features == 1


def test_clamp_subnormal_demotes():
    vals = np.array([1e-40, 0.0, 1.0], np.float32)
    batch = JColumnBatch(num_rows=3, dense={0: vals}, sparse={})
    specs = [jT.TransformSpec("Clamp", ("f0",), "out", (("lo", -1.0), ("hi", 1.0)))]
    te = _run_transform_engines(specs, batch)
    assert te.stats.demoted_features == 1 and te.stats.fused_features == 0


def test_bucketize_exact_ties_engine():
    borders = np.array([-1.0, 0.0, 0.0, 1.0])
    vals = np.array([-1.0, 0.0, -0.0, 1.0, -2.0, 2.0, np.nan, 0.5], np.float32)
    batch = JColumnBatch(num_rows=len(vals), dense={0: vals}, sparse={})
    specs = [jT.TransformSpec("Bucketize", ("f0",), "out", (("borders", borders),))]
    assert _run_transform_engines(specs, batch).stats.fused_features == 1


def test_mixed_wave_ragged_rows_engine():
    """Every fused op kind over ragged columns with scores, rows not a
    multiple of 32 and no row quantum."""
    rng = np.random.default_rng(2)
    n = 13
    lists = [rng.integers(-10 ** 12, 10 ** 12, size=rng.integers(0, 7)).tolist()
             for _ in range(n)]
    scores = [rng.normal(size=len(x)).astype(np.float32).tolist() for x in lists]
    batch = JColumnBatch(
        num_rows=n,
        dense={2: rng.normal(0, 5, n).astype(np.float32),
               3: rng.normal(0, 5, n).astype(np.float32)},
        sparse={0: _col(lists, scores), 1: _col([[x % 50] for x in range(n)])},
    )
    specs = [
        jT.TransformSpec("SigridHash", ("f0",), "h", (("salt", 7), ("max_value", 33))),
        jT.TransformSpec("PositiveModulus", ("f1",), "m", (("m", 13),)),
        jT.TransformSpec("Clamp", ("f2",), "c", (("lo", -2.0), ("hi", 2.0))),
        jT.TransformSpec("Bucketize", ("f3",), "b",
                         (("borders", np.linspace(-3, 3, 9)),)),
        jT.TransformSpec("Enumerate", ("h",), "e", ()),
        jT.TransformSpec("SigridHash", ("e",), "h2", (("salt", 2), ("max_value", 10))),
    ]
    te = _run_transform_engines(specs, batch, row_quantum=1)
    assert te.stats.fused_features == 5
    assert te.stats.kernel_launches == 4       # 3 fused waves + 1 fallback


def test_identity_lanes_pass_through_plain_version():
    """OP_IDENTITY differential (the reference's
    test_identity_lanes_pass_through_kernel): a wave mixing identity lanes
    with real ops leaves the identity columns bit-identical to the input.
    The port's plain ``fused_transform``, its dispatch (the op-code-static
    form, in both tile layouts) and the reference's Pallas kernel
    (interpret mode) and jnp oracle give the same bits."""
    from repro.kernels import ref as R
    from repro.kernels.ops import fused_transform as K
    from repro_torch.kernels import ops, ref

    assert ref.OP_IDENTITY == R.OP_IDENTITY == 0
    rng = np.random.default_rng(7)
    rows, feats = 6, 8
    ids = rng.integers(-2 ** 31, 2 ** 31, size=(rows, feats)).astype(np.int32)
    op_codes = np.array(
        [ref.OP_IDENTITY, ref.OP_SIGRID_HASH, ref.OP_IDENTITY, ref.OP_POSITIVE_MODULUS,
         ref.OP_IDENTITY, ref.OP_CLAMP, ref.OP_IDENTITY, ref.OP_BUCKETIZE],
        dtype=np.int32,
    )
    param0 = np.array([0, 7, 0, 0, 0, -50, 0, -100], dtype=np.int32)
    param1 = np.array([0, 33, 0, 13, 0, 50, 0, 10], dtype=np.int32)
    want = np.asarray(K(ids, op_codes, param0, param1, use_pallas=True))
    np.testing.assert_array_equal(
        np.asarray(R.fused_transform(ids, op_codes, param0, param1)), want)
    t_ids, t_codes, t_p0, t_p1 = map(torch.from_numpy, (ids, op_codes, param0, param1))
    got = {
        "plain": ref.fused_transform(t_ids, t_codes, t_p0, t_p1),
        "dispatch": ops.fused_transform(t_ids, t_codes, t_p0, t_p1),
        "features-major": ops.fused_transform(t_ids.T.contiguous(), t_codes, t_p0, t_p1,
                                              features_major=True).T,
    }
    for name, g in got.items():
        np.testing.assert_array_equal(g.numpy(), want, err_msg=name)
    identity_lanes = op_codes == ref.OP_IDENTITY
    np.testing.assert_array_equal(want[:, identity_lanes], ids[:, identity_lanes])
    assert not np.array_equal(want[:, ~identity_lanes], ids[:, ~identity_lanes])


def test_default_dlrm_pipeline_engines():
    """The production-shaped DAG end to end, generated features included,
    on a partition the reference generates."""
    s = j_make_schema("t", 6, 4, seed=0)
    batch = j_generate(s, 0, JDataGenConfig(rows_per_partition=300, seed=1))
    pipe = jT.default_dlrm_pipeline(s.dense_ids, s.sparse_ids, hash_size=500,
                                    n_derived=3)
    te = _run_transform_engines(pipe.specs, batch, row_quantum=256)
    assert te.stats.fused_features > 0
    assert te.stats.kernel_launches < len(pipe.specs)
    # the XLA-oracle dispatch of the reference engine agrees as well
    env_x = PallasEngine(pipe, use_pallas=None, row_quantum=256).run(batch)
    port_pipe = T.default_dlrm_pipeline(s.dense_ids, s.sparse_ids, hash_size=500,
                                        n_derived=3)
    env_t = TorchEngine(port_pipe, device="cpu", row_quantum=256).run(_to_port(batch))
    for k in env_x:
        _assert_column_identical(env_t[k], env_x[k], key=k)


def test_make_engine_resolution():
    pipe = T.TransformPipeline([])
    assert sorted(ENGINES) == ["numpy", "torch"]
    assert make_engine(None, pipe).name == "numpy"
    assert make_engine("numpy", pipe).name == "numpy"
    e = make_engine("torch", pipe, "cpu")
    assert e.name == "torch" and e.device.type == "cpu"
    assert make_engine(e, pipe) is e
    with pytest.raises(ValueError, match="unknown transform engine"):
        make_engine("pallas", pipe)


def test_cuda_engines_raise_without_cuda():
    """No fallback that hides the device: asking for CUDA where there is
    none raises instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the engines launch the kernels here")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TorchEngine(T.TransformPipeline([]))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TorchDecodeEngine()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        make_decode_engine("torch")


# -- decode engine ------------------------------------------------------------


def _adversarial_batch(rows, seed=0):
    """Dense: empty/partial/full presence; sparse: 0-nnz, scored,
    scored-but-empty, unscored."""
    rng = np.random.default_rng(seed)
    dense = {}
    for f, density in ((0, 0.0), (1, 0.5), (2, 1.0), (3, 0.9)):
        present = rng.random(rows) < density
        col = np.full(rows, np.nan, np.float32)
        col[present] = rng.standard_normal(int(present.sum())).astype(np.float32)
        if rows > 2 and density > 0:
            col[np.flatnonzero(present)[:2]] = np.array([1e-40, -0.0], np.float32)
        dense[f] = col
    sparse = {}
    for f, (nnz_max, scored) in ((10, (0, True)), (11, (5, True)),
                                 (12, (3, False)), (13, (0, False))):
        counts = (rng.integers(0, nnz_max + 1, rows) if nnz_max
                  else np.zeros(rows, np.int64))
        off = np.zeros(rows + 1, np.int64)
        np.cumsum(counts, out=off[1:])
        vals = rng.integers(0, 1 << 40, int(off[-1])).astype(np.int64)
        sc = rng.random(int(off[-1])).astype(np.float32) if scored else None
        sparse[f] = JSparseColumn(offsets=off, values=vals, scores=sc)
    return JColumnBatch(num_rows=rows, dense=dense, sparse=sparse,
                        labels=rng.random(rows).astype(np.float32))


@pytest.mark.parametrize("flattened", [True, False])
@pytest.mark.parametrize("codec", ["raw", "zlib"])
@pytest.mark.parametrize("rows", [517, 7, 0])
def test_decode_engines_on_adversarial_stripes(flattened, codec, rows):
    batch = _adversarial_batch(rows, seed=rows + 1)
    jf = jdwrf.write_dwrf(batch, jdwrf.DwrfWriterOptions(
        flattened=flattened, stripe_rows=256, codec=codec))
    f = dwrf.write_dwrf(_to_port(batch), dwrf.DwrfWriterOptions(
        flattened=flattened, stripe_rows=256, codec=codec))
    assert f.data == jf.data            # the port writes the reference's bytes
    fids = list(batch.dense) + list(batch.sparse)
    engines = [NumpyDecodeEngine(), TorchDecodeEngine(device="cpu")]
    for want in (fids, [1, 10, 13]):
        for stripe, port_stripe in zip(jf.footer.stripes, f.footer.stripes):
            fetch = {(s.fid, s.kind): jf.data[s.offset: s.offset + s.length]
                     for s in stripe.streams}
            ref = JNumpyDecode().decode_stripe(stripe, fetch, want)
            _assert_batches_identical(
                PallasDecodeEngine(use_pallas=True).decode_stripe(stripe, fetch, want),
                ref)
            for eng in engines:
                _assert_batches_identical(
                    eng.decode_stripe(port_stripe, fetch, want), ref)
    assert (engines[1].stats.kernel_launches > 0) == (rows > 0)


@pytest.mark.parametrize("flattened", [True, False])
@pytest.mark.parametrize("codec", ["raw", "zlib"])
def test_decode_engines_through_table_reader(flattened, codec):
    """Both packages generate the same warehouse from the same seeds; the
    port's torch decode engine reads it through the double-buffered
    TableReader byte-identically to the reference's engines."""
    cfg = dict(rows_per_partition=400, seed=3)
    opts = dict(flattened=flattened, stripe_rows=256, codec=codec)
    js = j_make_schema("t", 12, 6, seed=2)
    jtable = JWarehouse().create_table(js)
    jtable.generate(2, JDataGenConfig(**cfg), jdwrf.DwrfWriterOptions(**opts))
    s = make_schema("t", 12, 6, seed=2)
    table = Warehouse().create_table(s)
    table.generate(2, DataGenConfig(**cfg), dwrf.DwrfWriterOptions(**opts))
    for proj in (s.dense_ids + s.sparse_ids, s.dense_ids[:3] + s.sparse_ids[-2:]):
        for p in (0, 1):
            assert table.partitions[p].path == jtable.partitions[p].path
            want = JTableReader(jtable, proj, decode_engine=PallasDecodeEngine(
                use_pallas=True), double_buffer=True).read_rows(jtable.partitions[p])
            ref_np = JTableReader(jtable, proj, decode_engine="numpy",
                                  double_buffer=True).read_rows(jtable.partitions[p])
            _assert_batches_identical(want.batch, ref_np.batch)
            for eng in ("numpy", TorchDecodeEngine(device="cpu")):
                got = TableReader(table, proj, decode_engine=eng,
                                  double_buffer=True).read_rows(table.partitions[p])
                _assert_batches_identical(got.batch, want.batch)
                assert got.rows_decoded == want.rows_decoded


def test_make_decode_engine_resolution():
    assert sorted(DECODE_ENGINES) == ["numpy", "torch"]
    assert make_decode_engine(None).name == "numpy"
    e = make_decode_engine("torch", "cpu")
    assert e.name == "torch" and e.device.type == "cpu"
    assert make_decode_engine(e) is e
    assert make_decode_engine(lambda: NumpyDecodeEngine()).name == "numpy"
    with pytest.raises(ValueError, match="unknown decode engine"):
        make_decode_engine("pallas")


def test_sparse_column_round_trip_type():
    col = _to_port(JColumnBatch(num_rows=1, dense={}, sparse={3: _col([[1, 2]])}))
    assert isinstance(col.sparse[3], SparseColumn)
