"""The replay table and the on-policy rollout accumulator (port of `repro.core.buffer`).

Two of the reference's experience regimes:

* `BufferState` — the flat per-step replay table behind the off-policy
  family (``buffer_*``): FIFO overwrite, uniform sampling with
  replacement over the filled rows;
* `RolloutState` — the time-major ``(rollout_len, num_envs, ...)``
  trajectory (``(rollout_len, S, N, ...)`` with seed lanes) that the
  trainer consumes whole and then resets (``rollout_*``).

Unlike the reference, storage is written in place (nothing else holds a
reference to it), and the cursors (``insert_pos`` and ``size``, the
rollout's ``t``) are Python ints: they move by the same amount in every
lane whatever the data, so the runner's update gate reads them without
waiting on the device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import lanes as lanes_
from repro_torch.tree import tree_leaves, tree_map


class BufferState(NamedTuple):
    """Replay storage (leaves ``(capacity, ...)``, or ``(S, capacity, ...)``) + cursors.

    ``lanes`` is the number of seed lanes (None for a single run): each
    lane is its own table, and all of them fill in step.
    """

    storage: Any
    insert_pos: int
    size: int
    lanes: Optional[int] = None


def buffer_init(example_item, capacity: int, device, lanes: Optional[int] = None) -> BufferState:
    """``example_item``: a pytree of tensors with per-item shapes and dtypes."""
    lead = (capacity,) if lanes is None else (lanes, capacity)
    storage = tree_map(
        lambda x: torch.zeros((*lead, *x.shape), dtype=x.dtype, device=device), example_item
    )
    return BufferState(storage=storage, insert_pos=0, size=0, lanes=lanes)


def buffer_add(state: BufferState, items) -> BufferState:
    """Add a batch of items (leaves ``(B, ...)``, or ``(S, B, ...)``), overwriting FIFO.

    The rows go to ``insert_pos, insert_pos + 1, ...`` modulo the
    capacity, so a batch that reaches the end wraps to the start within
    the one add; each item is cast to its table's dtype, as the reference
    casts it.
    """
    axis = 0 if state.lanes is None else 1
    capacity = tree_leaves(state.storage)[0].shape[axis]
    B = tree_leaves(items)[0].shape[axis]
    # a batch larger than the table leaves only its last `capacity` rows,
    # where the reference's scatter lets the last write win
    skip = max(B - capacity, 0)
    start = (state.insert_pos + skip) % capacity
    n = B - skip
    head = min(n, capacity - start)

    def write(s, x):
        x = x.narrow(axis, skip, n)
        s.narrow(axis, start, head).copy_(x.narrow(axis, 0, head))
        if head < n:
            s.narrow(axis, 0, n - head).copy_(x.narrow(axis, head, n - head))

    tree_map(write, state.storage, items)
    return state._replace(insert_pos=(state.insert_pos + B) % capacity,
                          size=min(state.size + B, capacity))


def sample_indices(state: BufferState, generator, batch_size: int):
    """``batch_size`` uniform rows of ``[0, max(size, 1))``: ``(B,)``, or ``(S, B)``.

    One ``randint`` a lane generator (`repro_torch.lanes`).
    """
    device = tree_leaves(state.storage)[0].device
    lead = () if state.lanes is None else (state.lanes,)
    return lanes_.randint(generator, max(state.size, 1), (*lead, batch_size), device)


def buffer_sample(state: BufferState, generator, batch_size: int):
    """Uniform sample with replacement over the filled region.

    Leaves ``(batch_size, ...)``, or ``(S, batch_size, ...)`` with lanes:
    lane ``s`` samples its own table with its own generator.
    """
    idx = sample_indices(state, generator, batch_size)
    if state.lanes is None:
        return tree_map(lambda s: s.index_select(0, idx), state.storage)
    capacity = tree_leaves(state.storage)[0].shape[1]
    offsets = torch.arange(state.lanes, device=idx.device)[:, None] * capacity
    flat = (idx + offsets).flatten()
    return tree_map(
        lambda s: s.flatten(0, 1).index_select(0, flat).unflatten(0, idx.shape), state.storage
    )


def buffer_can_sample(state: BufferState, min_size: int) -> bool:
    """True once ``min_size`` rows are stored (a host-side test, no device read)."""
    return state.size >= min_size


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
