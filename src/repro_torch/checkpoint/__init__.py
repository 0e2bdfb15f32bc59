"""Checkpoints of the training state in the reference's on-disk format."""
from .manager import CheckpointManager, gather_tree, meta_target

__all__ = ["CheckpointManager", "gather_tree", "meta_target"]
