from repro_torch.checkpoint.store import (
    CheckpointManager,
    save_pytree,
    load_pytree,
)
