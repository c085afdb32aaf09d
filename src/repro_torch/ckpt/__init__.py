"""Checkpointing with atomic commits, async writes, content hashes and
resume-from-latest, in the reference's on-disk format (counterpart of
``repro.ckpt``)."""
from .checkpoint import (CheckpointManager, latest_step, load_checkpoint,
                         save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager"]
