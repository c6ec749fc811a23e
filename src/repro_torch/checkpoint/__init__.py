"""Sharded, async, elastic checkpoints in the reference's byte layout
(the partner of ``repro/checkpoint``)."""

from .checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                         save_checkpoint, snapshot)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint", "snapshot"]
