"""seamless-m4t-large-v2 — enc-dec multimodal backbone (audio frontend stub)
[arXiv:2308.11596]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    sharding_profile="fsdp",
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,          # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio",
)

SMOKE = dataclasses.replace(
    CONFIG, name="seamless-smoke", num_layers=2, encoder_layers=2,
    d_model=128, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
    vocab_size=512, remat=False,
)
