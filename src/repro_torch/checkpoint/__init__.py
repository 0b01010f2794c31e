"""Crash-consistent checkpoints of the port's train state."""
from repro_torch.checkpoint.store import CheckpointStore

__all__ = ["CheckpointStore"]
