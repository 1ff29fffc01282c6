"""qwen3-8b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    sharding_profile="fsdp",
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-smoke", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512, remat=False,
)
