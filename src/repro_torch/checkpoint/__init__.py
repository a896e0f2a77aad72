"""Checkable, durable checkpoints: the port's copy of ``repro.checkpoint``."""
from repro_torch.checkpoint.store import CheckpointStore
