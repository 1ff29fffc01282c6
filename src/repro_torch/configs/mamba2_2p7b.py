"""mamba2-2.7b — SSD (state-space duality) LM [arXiv:2405.21060]."""
import dataclasses

from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    sharding_profile="fsdp",
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="mamba2-smoke",
    num_layers=2,
    d_model=128,
    vocab_size=512,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=32),
    remat=False,
)
