"""Checkpoint / resume of the LM optimizer state."""

from tpu_ba_torch.checkpoint.state import load_checkpoint, save_checkpoint  # noqa: F401
