"""Asynchronous, atomic checkpoints of a training state."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
