"""Fault-tolerant checkpointing: atomic save/restore on the reference's
layout (PyTorch port of ``repro/checkpoint``)."""

from .manager import CheckpointManager, restore_tree, save_tree

__all__ = ["CheckpointManager", "save_tree", "restore_tree"]
