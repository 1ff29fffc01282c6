"""dlrm-paper — the paper's own model family (RM3-like scale, Table 4)."""
import dataclasses

from repro_torch.models.dlrm import DLRMConfig

CONFIG = DLRMConfig(
    name="dlrm-paper",
    num_dense=504,
    num_tables=42,
    vocab_per_table=2_000_000,
    embed_dim=128,
    max_ids_per_feature=32,
    bottom_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="dlrm-smoke",
    num_dense=16,
    num_tables=8,
    vocab_per_table=1000,
    embed_dim=16,
    max_ids_per_feature=8,
    bottom_mlp=(32, 16),
    top_mlp=(64, 32, 1),
)
