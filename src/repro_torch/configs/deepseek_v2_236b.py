"""deepseek-v2-236b — MLA (kv_lora=512) + MoE 160e top-6, 2 shared
[arXiv:2405.04434]."""
import dataclasses

from repro_torch.models.common import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab_size=102400,
    mla=MLAConfig(
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160, top_k=6, d_ff=1536,
        num_shared_experts=2, shared_d_ff=3072,
    ),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="deepseek-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=64,
    vocab_size=512,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=64, num_shared_experts=1, shared_d_ff=64),
    remat=False,
)
