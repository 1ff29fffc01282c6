"""The port's slice as a whole against the reference package.

The port's ``dlrm_dpp_batches`` (warehouse -> extract -> transform ->
batches, torch engines on CPU) at the ``dlrm-smoke`` widths serves the
same batches, byte for byte, as the reference's ``DPPSession``; the
port's data generation and DWRF writer make the reference's bytes; and no
module of the port imports JAX or the reference package.
"""
import ast
import dataclasses
import hashlib
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

from repro import configs as jconfigs  # noqa: E402
from repro.core import dwrf as jdwrf  # noqa: E402
from repro.core.datagen import DataGenConfig as JDataGenConfig  # noqa: E402
from repro.core.datagen import generate_partition as j_generate  # noqa: E402
from repro.core.schema import make_schema as j_make_schema  # noqa: E402
from repro.launch.train import dlrm_dpp_batches as j_dlrm_dpp_batches  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import column_batch_from_numpy  # noqa: E402
from repro_torch.core import dwrf  # noqa: E402
from repro_torch.core.datagen import DataGenConfig, generate_partition  # noqa: E402
from repro_torch.core.schema import make_schema  # noqa: E402
from repro_torch.launch import train  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SMOKE = jconfigs.get_smoke_config("dlrm-paper")
ROWS = 1024          # per partition; 2 partitions, stripes of 512
BATCH = 64


def _digest(batch) -> str:
    h = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(batch[k])
        h.update(f"{k}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _take_all(batches, session, n):
    """The session's n batches, then stop it (without the generator's
    end-of-data poll)."""
    try:
        return list(itertools.islice(batches, n))
    finally:
        session.stop()


def test_slice_matches_reference_session():
    n = 2 * ROWS // BATCH
    jb, js = j_dlrm_dpp_batches(SMOKE, BATCH, rows_per_partition=ROWS)
    want = _take_all(jb, js, n)
    pb, ps = train.dlrm_dpp_batches(configs.get_smoke_config("dlrm-paper"), BATCH,
                                    rows_per_partition=ROWS, device="cpu")
    got = _take_all(pb, ps, n)
    assert len(want) == len(got) == n
    # workers race, so the batch order is not fixed: compare multisets
    assert sorted(map(_digest, got)) == sorted(map(_digest, want))
    m = ps.worker_metrics()
    assert m.fused_features > 0 and m.decode_launches > 0
    assert ps.engine == "torch" and ps.decode_engine == "torch"
    assert set(got[0]) == {"dense", "sparse_ids", "sparse_mask", "label"}
    assert got[0]["dense"].shape == (BATCH, SMOKE.num_dense)
    assert got[0]["sparse_ids"].shape == (BATCH, SMOKE.num_tables,
                                          SMOKE.max_ids_per_feature)


def test_dlrm_paper_constants_match_reference():
    """The port's dlrm-paper CONFIG and SMOKE equal the reference's field by
    field (dtypes by name: torch's float32 for jnp's)."""
    for arch_cfg in ("get_config", "get_smoke_config"):
        got = getattr(configs, arch_cfg)("dlrm-paper")
        want = getattr(jconfigs, arch_cfg)("dlrm-paper")
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names
        for n in names:
            if n.endswith("_dtype"):
                assert str(getattr(got, n)) == f"torch.{np.dtype(getattr(want, n)).name}", n
            else:
                assert getattr(got, n) == getattr(want, n), n
        assert (got.num_layers, got.sub_quadratic, got.attention_free) == (
            want.num_layers, want.sub_quadratic, want.attention_free)
    with pytest.raises(KeyError, match="no-such-arch"):      # an arch neither package has
        configs.get_config("no-such-arch")
    with pytest.raises(KeyError):
        jconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("flattened", [True, False])
def test_datagen_and_dwrf_bytes_match_reference(flattened):
    """Same seeds, same bytes: the port's generator makes the reference's
    partition, and the port's writer, fed the reference's batch through
    convert.py, makes the reference's DWRF file."""
    js = j_make_schema("t", 10, 6, seed=4)
    s = make_schema("t", 10, 6, seed=4)
    jb = j_generate(js, 1, JDataGenConfig(rows_per_partition=300, seed=5))
    b = generate_partition(s, 1, DataGenConfig(rows_per_partition=300, seed=5))
    assert list(b.dense) == list(jb.dense) and list(b.sparse) == list(jb.sparse)
    for f in jb.dense:
        assert b.dense[f].tobytes() == jb.dense[f].tobytes()
    for f in jb.sparse:
        for x, y in ((b.sparse[f].offsets, jb.sparse[f].offsets),
                     (b.sparse[f].values, jb.sparse[f].values)):
            assert x.tobytes() == y.tobytes()
    assert b.labels.tobytes() == jb.labels.tobytes()

    converted = column_batch_from_numpy(
        jb.num_rows, dict(jb.dense),
        {f: (c.offsets, c.values, c.scores) for f, c in jb.sparse.items()},
        jb.labels,
    )
    for codec in ("raw", "zlib"):
        jf = jdwrf.write_dwrf(jb, jdwrf.DwrfWriterOptions(
            flattened=flattened, stripe_rows=128, codec=codec))
        f = dwrf.write_dwrf(converted, dwrf.DwrfWriterOptions(
            flattened=flattened, stripe_rows=128, codec=codec))
        assert f.data == jf.data


def test_convert_rejects_ragged_input():
    with pytest.raises(ValueError, match="rows"):
        column_batch_from_numpy(3, {1: np.zeros(2, np.float32)}, {})
    with pytest.raises(ValueError, match="offsets"):
        column_batch_from_numpy(
            3, {}, {2: (np.zeros(3, np.int64), np.zeros(0, np.int64), None)})


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "benchmarks" / "torch").rglob("*.py"))
    files += sorted((REPO / "examples" / "torch").rglob("*.py"))
    assert len(files) > 20
    covered = {p.parent.name for p in files}
    assert {"configs", "models", "optim", "train", "kernels", "core", "serving",
            "launch", "torch"} <= covered
    names = {str(p.relative_to(REPO)) for p in files}
    assert {"src/repro_torch/core/tokens.py", "examples/torch/lm_data_pipeline.py",
            "benchmarks/torch/ssd_routes.py"} <= names
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad
