"""codeqwen1.5-7b — dense MHA w/ QKV bias [hf:Qwen/CodeQwen1.5-7B]."""
import dataclasses

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    sharding_profile="fsdp",
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="codeqwen-smoke", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512, remat=False,
)
