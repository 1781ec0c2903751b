"""Checkpoints in the reference's on-disk layout."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, latest_checkpoint, list_checkpoints,
    restore_checkpoint, save_checkpoint)
