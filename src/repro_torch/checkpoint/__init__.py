"""Checkpointing: atomic, async, integrity-checked, keep-k."""

from .store import CheckpointStore

__all__ = ["CheckpointStore"]
