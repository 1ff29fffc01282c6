"""kimi-k2-1t-a32b — trillion-param MoE 384e top-8 (assignment-table config)
[arXiv:2501.kimi2]."""
import dataclasses

from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(
        num_experts=384, top_k=8, d_ff=2048,
        num_shared_experts=1, shared_d_ff=2048,
    ),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="kimi-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=64,
    vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=64, num_shared_experts=1, shared_d_ff=64),
    remat=False,
)
