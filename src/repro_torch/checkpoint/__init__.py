"""Atomic, retained checkpoints in the reference's format."""
from repro_torch.checkpoint.store import (  # noqa: F401
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
