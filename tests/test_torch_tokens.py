"""The port's LM token path (``repro_torch.core.tokens``) against the
reference's ``repro.core.tokens``.

Documents, packed sequences, the DWRF partitions ``build_corpus`` writes
and every batch of ``lm_batches_from_table`` are held equal to the
reference's, bit for bit: the path is integer data end to end.  The port
reads the table through its numpy decode engine and through its torch
engine on the CPU (``TorchDecodeEngine("cpu")``, the decode kernels'
plain versions).  DWRF bytes are compared within this machine: the codec
depends on whether ``zstandard`` imports.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro.core import tokens as JT  # noqa: E402
from repro.core.schema import SparseColumn as JSparseColumn  # noqa: E402
from repro.core.warehouse import Warehouse as JWarehouse  # noqa: E402
from repro_torch.core import tokens as T  # noqa: E402
from repro_torch.core.decode import TorchDecodeEngine  # noqa: E402
from repro_torch.core.schema import SparseColumn  # noqa: E402
from repro_torch.core.warehouse import Warehouse  # noqa: E402


def _equal_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("n_docs,vocab,seed,mean_len", [
    (8, 512, 0, 512.0), (33, 151_936, 7, 64.0), (1, 2, 3, 16.0)])
def test_generate_documents_matches_reference(n_docs, vocab, seed, mean_len):
    got = T.generate_documents(n_docs, vocab, seed=seed, mean_len=mean_len)
    want = JT.generate_documents(n_docs, vocab, seed=seed, mean_len=mean_len)
    assert got.num_rows == want.num_rows and not got.dense and not want.dense
    g, w = got.sparse[T.DOC_FEATURE_ID], want.sparse[JT.DOC_FEATURE_ID]
    np.testing.assert_array_equal(g.offsets, w.offsets)
    np.testing.assert_array_equal(g.values, w.values)
    assert g.values.dtype == w.values.dtype and g.offsets.dtype == w.offsets.dtype


def test_schema_and_constants_match_reference():
    assert (T.DOC_FEATURE_ID, T.EOS) == (JT.DOC_FEATURE_ID, JT.EOS)
    got, want = T.token_schema("docs"), JT.token_schema("docs")
    assert got.name == want.name and sorted(got.features) == sorted(want.features)
    for fid, w in want.features.items():
        g = got.features[fid]
        assert (g.fid, g.name, g.ftype.name, g.coverage, g.avg_length, g.cardinality) == (
            w.fid, w.name, w.ftype.name, w.coverage, w.avg_length, w.cardinality)


def test_pack_sequences_matches_reference_across_calls():
    """Three calls carrying the leftover, one document longer than
    seq_len + 1 (it spans rows), one call whose stream fills no row."""
    rng = np.random.default_rng(0)
    seq_len = 16
    lengths = [[3, 40, 5], [2], [17, 18, 1, 9]]       # 40 > seq_len + 1
    state, jstate = None, None
    for call in lengths:
        offsets = np.concatenate([[0], np.cumsum(call)]).astype(np.int64)
        values = rng.integers(1, 500, int(offsets[-1])).astype(np.int64)
        got, state = T.pack_sequences(SparseColumn(offsets=offsets, values=values),
                                      seq_len, state)
        want, jstate = JT.pack_sequences(JSparseColumn(offsets=offsets, values=values),
                                         seq_len, jstate)
        assert got.dtype == want.dtype == np.int32
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(state.leftover, jstate.leftover)
        assert state.leftover.dtype == jstate.leftover.dtype
    assert len(state.leftover) > 0


def _corpora(n_partitions=3, docs=24, vocab=1024, seed=5):
    wh, jwh = Warehouse(), JWarehouse()
    table = T.build_corpus(wh, n_partitions, docs, vocab, seed=seed)
    jtable = JT.build_corpus(jwh, n_partitions, docs, vocab, seed=seed)
    return table, jtable


def test_build_corpus_writes_the_reference_partitions():
    table, jtable = _corpora()
    metas, jmetas = table.select_partitions(None), jtable.select_partitions(None)
    assert [m.path for m in metas] == [m.path for m in jmetas]
    assert table.total_rows == jtable.total_rows
    assert table.total_bytes == jtable.total_bytes
    for m, jm in zip(metas, jmetas):
        assert table.fs.peek(m.path) == jtable.fs.peek(jm.path)


@pytest.mark.parametrize("engine", ["numpy", "torch-cpu"])
@pytest.mark.parametrize("seq_len,batch_size,partitions", [
    (64, 4, None), (128, 8, [2, 0]), (31, 3, [1])])
def test_lm_batches_match_reference(engine, seq_len, batch_size, partitions):
    table, jtable = _corpora()
    decode = TorchDecodeEngine("cpu") if engine == "torch-cpu" else None
    got = list(T.lm_batches_from_table(table, seq_len, batch_size, partitions,
                                       decode_engine=decode))
    want = list(JT.lm_batches_from_table(jtable, seq_len, batch_size, partitions))
    assert len(want) > 1
    _equal_batches(got, want)
    for b in got:
        assert b["tokens"].shape == (batch_size, seq_len)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    if decode is not None:
        assert decode.stats.kernel_launches > 0


def test_token_packing_roundtrip():
    """``tests/test_extensions.py::test_token_packing_roundtrip`` on the
    port: 8 x 64 batches whose labels are the tokens shifted."""
    table = T.build_corpus(Warehouse(), n_partitions=2, docs_per_partition=64,
                           vocab_size=512, seed=0)
    batches = list(T.lm_batches_from_table(table, seq_len=64, batch_size=8))
    assert len(batches) > 4
    for b in batches:
        assert b["tokens"].shape == (8, 64)
        assert b["labels"].shape == (8, 64)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
        assert (b["tokens"] >= 0).all() and (b["tokens"] < 512).all()


def test_pack_sequences_preserves_tokens():
    """``tests/test_extensions.py::test_pack_sequences_preserves_tokens``
    on the port: the packed rows and the leftover are the EOS-separated
    stream."""
    lists = [[5, 6, 7], [8, 9], [10, 11, 12, 13]]
    off = np.zeros(4, np.int64)
    np.cumsum([len(l) for l in lists], out=off[1:])
    col = SparseColumn(offsets=off, values=np.concatenate(lists).astype(np.int64))
    packed, state = T.pack_sequences(col, seq_len=3)
    stream = np.concatenate([packed.reshape(-1), state.leftover])
    expect = [5, 6, 7, T.EOS, 8, 9, T.EOS, 10, 11, 12, 13, T.EOS]
    np.testing.assert_array_equal(stream, expect)
