"""``repro_torch.distributed.spawn`` and ``launch.mesh.Mesh`` on gloo
ranks on the CPU: the mesh's coordinates and collectives, and a failed
or hung rank raising in the caller within the join's timeout."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (cores shared among xdist's workers)

import torch_sharded_ranks  # noqa: E402
from repro_torch.distributed.spawn import spawn  # noqa: E402


def test_mesh_coordinates_and_collectives(tmp_path):
    results = spawn(torch_sharded_ranks.mesh_rank, 4, str(tmp_path / "rdv"), "gloo",
                    timeout_s=60)
    xs = [np.array([float(r), 10.0 * r], np.float32) for r in range(4)]
    for rank, r in enumerate(results):
        assert r["shape"] == {"data": 2, "model": 2}
        d, m = r["coord"]
        assert rank == 2 * d + m                         # row-major
        np.testing.assert_array_equal(r["sum_model"], xs[2 * d] + xs[2 * d + 1])
        np.testing.assert_array_equal(r["sum_all"], sum(xs))
        np.testing.assert_array_equal(r["x_kept"], xs[rank])
        np.testing.assert_array_equal(r["gather_data"], np.stack([xs[m], xs[2 + m]]))
        np.testing.assert_array_equal(r["gather_all"], np.stack(xs))
        np.testing.assert_array_equal(r["size1_sum"], xs[rank])
        np.testing.assert_array_equal(r["size1_gather"], xs[rank][None])
        assert len(r["refused"]) == 2, r["refused"]
    assert not (tmp_path / "rdv").exists()


def test_failed_rank_raises(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        spawn(torch_sharded_ranks.failing_rank, 2, str(tmp_path / "rdv"), "gloo", timeout_s=60)


def test_hung_rank_times_out(tmp_path):
    t = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn(torch_sharded_ranks.hanging_rank, 1, str(tmp_path / "rdv"), "gloo", timeout_s=15)
    assert time.monotonic() - t < 40
    with pytest.raises(FileExistsError):
        (tmp_path / "used").write_text("")
        spawn(torch_sharded_ranks.failing_rank, 1, str(tmp_path / "used"), "gloo")
