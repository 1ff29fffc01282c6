"""The frozen counts against hand counts at smoke sizes."""
import numpy as np
import pytest

from dsibench import counts

LM = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
          vocab_size=512)
DLRM = dict(num_dense=16, num_tables=8, vocab_per_table=1000, embed_dim=16,
            max_ids_per_feature=8, bottom_mlp=[32, 16], top_mlp=[64, 32, 1])


def test_lm_step_flops():
    # a layer: wq 4096 + wk 2048 + wv 2048 + wo 4096 + MLP 3 x 8192; head 32768
    assert counts.lm_matmul_params(LM) == 2 * 36864 + 32768
    # 6 x 106,496 x 128 tokens + 6 x 2 layers x 2 rows x 4 heads x 64^2 x 16
    assert counts.lm_step_flops(LM, 2, 64) == 81_788_928 + 6_291_456


def test_lm_step_flops_at_qwen3_8b_widths():
    m = dict(num_layers=4, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
             d_ff=12288, vocab_size=151936)
    # 4 x (2 x 16.8M + 2 x 4.2M + 3 x 50.3M) + 622.3M matrix parameters
    assert counts.lm_matmul_params(m) == 4 * 192_937_984 + 622_329_856
    # 6 x 1,394,081,792 x 8,192 + 6 x 4 x 2 x 32 x 4096^2 x 128
    assert counts.lm_step_flops(m, 2, 4096) == 68_521_908_240_384 + 3_298_534_883_328


def test_dlrm_step_flops_and_bytes():
    # MLP multiply-adds 16x32 + 32x16 + 52x64 + 64x32 + 32x1 = 6432; the
    # top MLP's input is 16 + 8 x 9 / 2 = 52
    assert counts.dlrm_mlp_params(DLRM) == 1072 + 5505
    assert counts.dlrm_step_flops(DLRM, 4) == 6 * 4 * 6432 - 2 * 4 * 16 * 32 + 4 * 4 * 81 * 16
    ids = np.zeros((4, 8, 8), np.int32)
    mask = np.zeros((4, 8, 8), np.float32)
    ids[0, 0, :3] = [5, 5, 7]
    mask[0, 0, :3] = 1
    ids[1, 1, 0] = 5
    mask[1, 1, 0] = 1
    ids[2, 0, 4] = 9                      # a dead slot: not counted
    batch = {"sparse_ids": ids, "sparse_mask": mask,
             "dense": np.zeros((4, 16), np.float32), "label": np.zeros(4, np.float32)}
    assert counts.unique_live_rows(ids, mask, 1000) == 3
    # 3 rows x (3 x 64 B of a row + 8 B of accumulator), the batch's
    # 1024 + 1024 + 256 + 16 bytes, 8 x 4 B x 6577 MLP parameters
    assert counts.dlrm_step_bytes(DLRM, batch) == 600 + 2320 + 210_464


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(67e12, 3.35e12, 67e12, 3.35e12) == 1.0
    assert counts.least_seconds(1e12, 6.7e12, 67e12, 3.35e12) == pytest.approx(2.0)
