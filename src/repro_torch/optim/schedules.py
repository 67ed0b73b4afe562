"""Learning-rate schedules (counterpart of `repro.optim.schedules`).

Each schedule maps a step (a Python int or a 0-d tensor, such as an
optimizer's ``count``) to a 0-d float32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch


def _as_float(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(value: float):
    """``value`` at every step."""

    def schedule(step):
        return torch.full_like(_as_float(step), value)

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """From ``init_value`` at step 0 to ``end_value`` at ``transition_steps``, then flat."""

    def schedule(step):
        frac = torch.clamp(_as_float(step) / max(transition_steps, 1), 0.0, 1.0)
        return init_value + frac * (end_value - init_value)

    return schedule


def linear_warmup_cosine_decay(
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
):
    """Linear warmup to ``peak_value`` over ``warmup_steps``, then a cosine down to
    ``end_value`` at ``decay_steps``, then flat."""

    def schedule(step):
        step = _as_float(step)
        warm = peak_value * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
        cos = end_value + 0.5 * (peak_value - end_value) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
