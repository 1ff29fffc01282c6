from repro_torch.optim.optimizers import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_grads,
    decompress_grads,
    global_norm,
    wsd_schedule,
)

__all__ = [
    "OptimizerConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
    "compress_grads", "decompress_grads", "global_norm", "wsd_schedule",
]
