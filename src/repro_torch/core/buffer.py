"""The on-policy rollout accumulator (port of `repro.core.buffer`'s ``rollout_*``).

A time-major ``(rollout_len, num_envs, ...)`` trajectory (``(rollout_len,
S, N, ...)`` with seed lanes) that the trainer
consumes whole and then resets.  Unlike the reference, storage is written
in place (nothing else holds a reference to it), and the cursor ``t`` is
a Python int, so the runner's update gate reads it without waiting on the
device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class RolloutState(NamedTuple):
    """Rollout storage (leaves ``(rollout_len, num_envs, ...)``) + cursor."""

    storage: Any
    t: int  # next write slot (t == rollout_len means full)


def rollout_init(example_item, rollout_len: int, num_envs, device) -> RolloutState:
    """``example_item``: a pytree of tensors with per-item shapes and dtypes.

    ``num_envs`` is the batch of one step: an int, or a shape such as
    ``(S, N)`` for seed lanes (storage ``(rollout_len, S, N, ...)``).
    """
    batch = (num_envs,) if isinstance(num_envs, int) else tuple(num_envs)
    storage = tree_map(
        lambda x: torch.zeros((rollout_len, *batch, *x.shape), dtype=x.dtype, device=device),
        example_item,
    )
    return RolloutState(storage=storage, t=0)


def rollout_add(state: RolloutState, items) -> RolloutState:
    """Write one vectorised step (leaves ``(*batch, ...)``) at the cursor.

    Writes past the end are dropped, as the reference's out-of-bounds
    scatter drops them (PyTorch indexing would raise instead).
    """
    rollout_len = tree_leaves(state.storage)[0].shape[0]
    if state.t < rollout_len:
        tree_map(lambda s, x: s[state.t].copy_(x), state.storage, items)
    return RolloutState(storage=state.storage, t=state.t + 1)


def rollout_ready(state: RolloutState, rollout_len: int) -> bool:
    """True once the accumulator holds a complete rollout."""
    return state.t >= rollout_len


def rollout_take(state: RolloutState):
    """The full time-major trajectory (leaves ``(rollout_len, num_envs, ...)``)."""
    return state.storage


def rollout_reset(state: RolloutState) -> RolloutState:
    """Consume: rewind the cursor (storage is overwritten in place)."""
    return RolloutState(storage=state.storage, t=0)
