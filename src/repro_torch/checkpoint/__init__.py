"""Checkpoints of train states (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpoint import CheckpointManager, load, save

__all__ = ["CheckpointManager", "load", "save"]
