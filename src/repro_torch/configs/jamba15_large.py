"""jamba-1.5-large — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
import dataclasses

from repro_torch.models.common import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_width=4, chunk=256),
    block_period=8,
    attn_index=4,
    moe_period=2,
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="jamba-smoke",
    num_layers=8,          # one block
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=256),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=32),
    remat=False,
)
