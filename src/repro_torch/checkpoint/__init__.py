"""Checkpoints of the training state in the reference's on-disk format."""
from .manager import CheckpointManager, meta_target

__all__ = ["CheckpointManager", "meta_target"]
