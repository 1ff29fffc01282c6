"""LM token path through the DSI pipeline.

A port of the reference's ``repro.core.tokens``.  The paper's DPP is
model-agnostic: LM training jobs consume the same warehouse/DPP
substrate with a token-packing flavor instead of the DLRM sparse-feature
transforms.  Documents are stored as a sparse column (variable-length
token-id lists) in a partitioned table; the packing transform
concatenates documents into fixed-length training sequences (with EOS
separators), which is the "materialize tensors" step for LMs.

``lm_batches_from_table`` takes one keyword the reference's lacks,
``decode_engine``, passed to ``TableReader``: ``None`` keeps the numpy
engine, ``"torch"`` (or a ``TorchDecodeEngine``) runs extract through
the decode kernels.  Every engine gives the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import dwrf
from repro_torch.core.schema import (
    ColumnBatch,
    FeatureDef,
    FeatureType,
    SparseColumn,
    TableSchema,
)
from repro_torch.core.warehouse import Table, Warehouse

DOC_FEATURE_ID = 0
EOS = 0


def token_schema(name: str = "lm_docs") -> TableSchema:
    return TableSchema(
        name=name,
        features={
            DOC_FEATURE_ID: FeatureDef(
                fid=DOC_FEATURE_ID, name="tokens", ftype=FeatureType.SPARSE,
                coverage=1.0, avg_length=512.0, cardinality=1 << 31,
            )
        },
    )


def generate_documents(
    n_docs: int, vocab_size: int, seed: int = 0,
    mean_len: float = 512.0,
) -> ColumnBatch:
    """Synthetic corpus partition: Zipf tokens, log-normal doc lengths."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(
        rng.lognormal(np.log(mean_len), 0.6, n_docs), 16, 8 * mean_len
    ).astype(np.int64)
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    toks = (rng.zipf(1.3, int(offsets[-1])) % (vocab_size - 1) + 1).astype(np.int64)
    col = SparseColumn(offsets=offsets, values=toks)
    return ColumnBatch(num_rows=n_docs, dense={}, sparse={DOC_FEATURE_ID: col})


def build_corpus(
    wh: Warehouse, n_partitions: int, docs_per_partition: int,
    vocab_size: int, seed: int = 0, name: str = "lm_docs",
) -> Table:
    table = wh.create_table(token_schema(name))
    for p in range(n_partitions):
        batch = generate_documents(docs_per_partition, vocab_size, seed=(seed, p).__hash__() & 0x7FFFFFFF)
        table.write_partition(p, batch, dwrf.DwrfWriterOptions(flattened=True, stripe_rows=256))
    return table


@dataclasses.dataclass
class PackState:
    """Carry-over tokens between splits (documents span split boundaries)."""
    leftover: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))


def pack_sequences(
    docs: SparseColumn,
    seq_len: int,
    state: Optional[PackState] = None,
) -> Tuple[np.ndarray, PackState]:
    """Concatenate docs (EOS-separated) into (n, seq_len+1) int32 rows; the
    +1 column provides next-token labels via shifting."""
    state = state or PackState()
    parts: List[np.ndarray] = [state.leftover]
    for i in range(docs.rows):
        parts.append(docs.row(i))
        parts.append(np.asarray([EOS], np.int64))
    stream = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    stride = seq_len + 1
    n = len(stream) // stride
    packed = stream[: n * stride].reshape(n, stride).astype(np.int32)
    return packed, PackState(leftover=stream[n * stride:])


def lm_batches_from_table(
    table: Table,
    seq_len: int,
    batch_size: int,
    partitions: Optional[List[int]] = None,
    decode_engine=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """One-epoch LM batch stream: selective read -> pack -> batch.
    ``decode_engine`` picks extract's engine (``TableReader``)."""
    from repro_torch.core.reader import TableReader

    reader = TableReader(table, [DOC_FEATURE_ID], decode_engine=decode_engine)
    state = PackState()
    buf: List[np.ndarray] = []
    for meta in table.select_partitions(partitions):
        res = reader.read_partition(meta)
        packed, state = pack_sequences(res.batch.sparse[DOC_FEATURE_ID], seq_len, state)
        buf.append(packed)
        rows = np.concatenate(buf) if buf else np.zeros((0, seq_len + 1), np.int32)
        while len(rows) >= batch_size:
            chunk, rows = rows[:batch_size], rows[batch_size:]
            yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
        buf = [rows]
    reader.finish_job()
