"""Pytree checkpoints in the reference's .npz format (port of `repro.checkpoint`)."""
from repro_torch.checkpoint.ckpt import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
