"""Checkpoints in the reference's on-disk format (``checkpoint/ckpt.py``)."""
from repro_torch.checkpoint.ckpt import (
    latest_step, load_checkpoint, load_checkpoint_extra, restore_checkpoint,
    save_checkpoint, validate_run_config,
)
