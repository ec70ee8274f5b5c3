from repro_torch.checkpoint.store import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
    sweep_stale_tmp,
)

__all__ = [
    "CheckpointManager",
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
    "sweep_stale_tmp",
]
