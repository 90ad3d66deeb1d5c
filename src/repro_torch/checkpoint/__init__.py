"""Async write-behind checkpointing (atomic, in the reference's format)."""
from .ckpt import CheckpointManager

__all__ = ["CheckpointManager"]
