from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager, latest_step, restore_checkpoint, save_checkpoint,
)
