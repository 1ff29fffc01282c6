"""llava-next-mistral-7b — VLM, mistral backbone + anyres patch stub
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    sharding_profile="fsdp",
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    frontend="vision",
    num_patches=2880,      # anyres: (4 tiles + base) x 576 patches
)

SMOKE = dataclasses.replace(
    CONFIG, name="llava-smoke", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
    num_patches=16, remat=False,
)
