"""Optimizers as pure gradient transformations (port of `repro.optim`)."""
from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    adamw,
    apply_updates,
    chain,
    clip_by_global_norm,
    global_norm,
)

__all__ = [
    "AdamState",
    "Optimizer",
    "adamw",
    "apply_updates",
    "chain",
    "clip_by_global_norm",
    "global_norm",
]
