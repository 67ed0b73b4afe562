"""Optimizers as pure gradient transformations (port of `repro.optim`)."""
from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    RmspropState,
    SgdState,
    adam,
    adamw,
    apply_updates,
    chain,
    clip_adamw_in_place,
    clip_by_global_norm,
    global_norm,
    rmsprop,
    scale,
    sgd,
)
from repro_torch.optim.schedules import (
    constant,
    linear_schedule,
    linear_warmup_cosine_decay,
)

# the reference's `__all__` in its order, then the port's own names
__all__ = [
    "Optimizer",
    "adamw",
    "adam",
    "sgd",
    "rmsprop",
    "chain",
    "clip_by_global_norm",
    "scale",
    "apply_updates",
    "global_norm",
    "constant",
    "linear_warmup_cosine_decay",
    "linear_schedule",
    "AdamState",
    "SgdState",
    "RmspropState",
    "clip_adamw_in_place",
]
