"""repro_torch.checkpoint — atomic, checksummed, keep-k, async
checkpoints in the reference's layout."""
from .checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                         save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
