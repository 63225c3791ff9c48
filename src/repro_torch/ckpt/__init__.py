"""Checkpointing with async write and restore onto any device
(``repro/ckpt``)."""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    save_checkpoint, restore_checkpoint, AsyncCheckpointer, latest_step)
