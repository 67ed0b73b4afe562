"""The replay table and the on-policy rollout accumulator (port of `repro.core.buffer`).

The reference's three experience regimes:

* `BufferState` — the flat per-step replay table behind the off-policy
  family (``buffer_*``): FIFO overwrite, uniform sampling with
  replacement over the filled rows;
* `RolloutState` — the time-major ``(rollout_len, num_envs, ...)``
  trajectory (``(rollout_len, S, N, ...)`` with seed lanes) that the
  trainer consumes whole and then resets (``rollout_*``);
* `SeqBufferState` — R2D2 sequence replay for recurrent off-policy
  systems (``seq_*``): every ``stride`` steps, once ``window_len`` steps
  have come in, the last ``window_len`` rows of each env become one stored
  window (FIFO at capacity), and sampling draws whole windows,
  time-major.  The executor's incoming carry rides in the stored rows
  (``Transition.extras["carry_in"]``), so a window opens from the stored
  memory.

Beside the three datasets, `QueueState` is a transport: the bounded FIFO
of trajectory chunks between the async runner's actors and its learner
(``queue_*``; a full queue drops the incoming item).

Unlike the reference, storage is written in place (nothing else holds a
reference to it), and the cursors (``insert_pos`` and ``size``, the
rollout's ``t``, the sequence table's step count) are Python ints: they
move by the same amount in every lane whatever the data, so the runner's
update gate reads them without waiting on the device.  A sequence table
writes its windows only on the steps that flush, where the reference
rewrites the slots every step under a mask.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
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


def _ring_write(s, x, axis: int, insert_pos: int):
    """Write ``x``'s rows along ``axis`` into the table ``s`` at ``insert_pos, insert_pos + 1, ...``.

    The rows wrap to the start at the table's end, and are cast to its
    dtype, as the reference casts them.  More rows than slots leave only
    the last ``capacity``, where the reference's scatter lets the last
    write win.
    """
    capacity, B = s.shape[axis], x.shape[axis]
    skip = max(B - capacity, 0)
    start = (insert_pos + skip) % capacity
    n = B - skip
    head = min(n, capacity - start)
    x = x.narrow(axis, skip, n)
    s.narrow(axis, start, head).copy_(x.narrow(axis, 0, head))
    if head < n:
        s.narrow(axis, 0, n - head).copy_(x.narrow(axis, head, n - head))


def buffer_add(state: BufferState, items) -> BufferState:
    """Add a batch of items (leaves ``(B, ...)``, or ``(S, B, ...)``), overwriting FIFO.

    The rows go to ``insert_pos, insert_pos + 1, ...`` modulo the
    capacity, so a batch that reaches the end wraps to the start within
    the one add.
    """
    axis = 0 if state.lanes is None else 1
    capacity = tree_leaves(state.storage)[0].shape[axis]
    B = tree_leaves(items)[0].shape[axis]
    tree_map(lambda s, x: _ring_write(s, x, axis, state.insert_pos), state.storage, items)
    return state._replace(insert_pos=(state.insert_pos + B) % capacity,
                          size=min(state.size + B, capacity))


def sample_indices(state: BufferState, generator, batch_size: int):
    """``batch_size`` uniform rows of ``[0, max(size, 1))``: ``(B,)``, or ``(S, B)``.

    One ``randint`` a lane generator (`repro_torch.lanes`).
    """
    device = tree_leaves(state.storage)[0].device
    lead = () if state.lanes is None else (state.lanes,)
    return lanes_.randint(generator, max(state.size, 1), (*lead, batch_size), device)


def _gather_rows(storage, idx, lanes):
    """Rows ``idx`` of each table: ``(B, ...)``, or ``(S, B, ...)`` with lane tables."""
    if lanes is None:
        return tree_map(lambda s: s.index_select(0, idx), storage)
    capacity = tree_leaves(storage)[0].shape[1]
    offsets = torch.arange(lanes, device=idx.device)[:, None] * capacity
    flat = (idx + offsets).flatten()
    return tree_map(lambda s: s.flatten(0, 1).index_select(0, flat).unflatten(0, idx.shape),
                    storage)


def buffer_sample(state: BufferState, generator, batch_size: int):
    """Uniform sample with replacement over the filled region.

    Leaves ``(batch_size, ...)``, or ``(S, batch_size, ...)`` with lanes:
    lane ``s`` samples its own table with its own generator.
    """
    return _gather_rows(state.storage, sample_indices(state, generator, batch_size), state.lanes)


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


# ------------------------------------------------------------ sequence replay


class SeqBufferState(NamedTuple):
    """Sequence-replay table: stored windows, and a ring of the live step stream.

    ``storage`` leaves are ``(capacity, window_len, ...)`` windows and
    ``acc`` leaves the ``(window_len, num_envs, ...)`` ring; with ``lanes``
    both lead with the lane axis, ``(S, capacity, window_len, ...)`` and
    ``(S, window_len, num_envs, ...)``, one table a lane.  ``t`` counts the
    steps observed, and ``size`` is a function of it alone
    (`seq_expected_size`).
    """

    storage: Any
    acc: Any
    t: int
    insert_pos: int
    size: int
    lanes: Optional[int] = None


def seq_init(example_item, capacity: int, window_len: int, num_envs, device) -> SeqBufferState:
    """A fresh table of ``capacity`` windows of ``window_len`` steps.

    ``example_item``: a pytree of tensors with per-item shapes and dtypes
    (for recurrent systems a `Transition` whose extras carry the per-step
    ``carry_in``).  ``num_envs`` is the batch of one step: ``N``, or
    ``(S, N)`` for seed lanes; each flush stores one window an env.
    """
    batch = (num_envs,) if isinstance(num_envs, int) else tuple(num_envs)
    lanes = batch[0] if len(batch) == 2 else None
    lead = () if lanes is None else (lanes,)
    storage = tree_map(
        lambda x: torch.zeros((*lead, capacity, window_len, *x.shape), dtype=x.dtype,
                              device=device), example_item)
    acc = tree_map(
        lambda x: torch.zeros((*lead, window_len, batch[-1], *x.shape), dtype=x.dtype,
                              device=device), example_item)
    return SeqBufferState(storage, acc, t=0, insert_pos=0, size=0, lanes=lanes)


def seq_add(state: SeqBufferState, items, *, stride: int) -> SeqBufferState:
    """Append one vectorised step (leaves ``(N, ...)``, or ``(S, N, ...)``); flush windows.

    The step lands in the ring; once ``window_len`` steps have come in,
    every ``stride``-th step flushes it: the last ``window_len`` rows of
    each env, in time order, become windows at ``insert_pos, insert_pos +
    1, ...`` modulo the capacity.  ``stride < window_len`` makes
    consecutive windows overlap by ``window_len - stride`` steps.  Whether
    a step flushes depends on the step count alone.
    """
    axis = 0 if state.lanes is None else 1  # the ring's time axis, the table's slot axis
    window_len, num_envs = tree_leaves(state.acc)[0].shape[axis:axis + 2]
    capacity = tree_leaves(state.storage)[0].shape[axis]
    pos = state.t % window_len
    tree_map(lambda a, x: a.select(axis, pos).copy_(x), state.acc, items)
    t1 = state.t + 1
    if t1 < window_len or (t1 - window_len) % stride:
        return state._replace(t=t1)
    # a window an env, in time order: the ring rotated to start after pos
    # (two slices: an index list would be copied to the device, a wait)
    cut = (pos + 1) % window_len

    def flush(s, a):
        windows = torch.cat([a.narrow(axis, cut, window_len - cut), a.narrow(axis, 0, cut)],
                            dim=axis).movedim(axis, axis + 1)
        _ring_write(s, windows, axis, state.insert_pos)

    tree_map(flush, state.storage, state.acc)
    return state._replace(t=t1, insert_pos=(state.insert_pos + num_envs) % capacity,
                          size=min(state.size + num_envs, capacity))


def seq_sample(state: SeqBufferState, generator, batch_size: int):
    """``batch_size`` whole windows, uniform with replacement, time-major.

    Leaves ``(window_len, batch_size, ...)``, or ``(window_len, S,
    batch_size, ...)`` with lanes: the layout BPTT trainers consume from a
    rollout, stored ``extras["carry_in"]`` rows included.  The window
    indices come from `sample_indices`, as the flat table's rows do.
    """
    windows = _gather_rows(state.storage, sample_indices(state, generator, batch_size),
                           state.lanes)
    axis = 0 if state.lanes is None else 1
    return tree_map(lambda x: x.movedim(axis + 1, 0), windows)


def seq_can_sample(state: SeqBufferState, min_windows: int) -> bool:
    """True once ``min_windows`` windows are stored (a host-side test)."""
    return state.size >= min_windows


def seq_expected_size(t: int, capacity: int, window_len: int, num_envs: int, stride: int) -> int:
    """The closed-form ``size`` after ``t`` `seq_add` calls.

    ``t`` steps flush ``max(0, (t - window_len) // stride + 1)`` times,
    ``num_envs`` windows each, capped at ``capacity``.
    """
    flushes = max(0, (t - window_len) // stride + 1)
    return min(num_envs * flushes, capacity)


# ------------------------------------------------------- trajectory queue


class QueueState(NamedTuple):
    """A fixed-capacity FIFO ring of item slots: the async runner's transport.

    ``storage`` leaves are preallocated ``(capacity, ...)`` tensors, one
    slot an item, written by slot copies; a leaf of the example item that
    is not a tensor (a snapshot's update count) gets a numpy object array
    of ``capacity`` entries.  ``head`` (the oldest item's slot) and
    ``size`` are Python ints: what the queue holds is known on the host,
    so no push or pop waits on the device.
    """

    storage: Any
    head: int
    size: int


def queue_init(example_item, capacity: int, device=None) -> QueueState:
    """A fresh empty queue; ``example_item`` fixes the slots' shapes and dtypes."""

    def slots(x):
        if isinstance(x, torch.Tensor):
            return torch.zeros((capacity, *x.shape), dtype=x.dtype, device=device or x.device)
        out = np.empty(capacity, dtype=object)
        out[:] = [x] * capacity
        return out

    return QueueState(storage=tree_map(slots, example_item), head=0, size=0)


def queue_capacity(state: QueueState) -> int:
    """The number of slots the queue was built with."""
    return len(tree_leaves(state.storage)[0])


def queue_size(state: QueueState) -> int:
    """How many items are queued."""
    return state.size


def _write_slot(s, x, slot):
    if isinstance(s, torch.Tensor):
        s[slot].copy_(x)
    else:
        s[slot] = x


def queue_push(state: QueueState, item):
    """Enqueue ``item`` at the tail; a full queue drops the *incoming* item.

    Returns ``(state, accepted)``: ``accepted`` is False when the item was
    dropped, and the queued items are then left as they were.  Tensors
    are cast to the slot's dtype, as the reference casts them.
    """
    capacity = queue_capacity(state)
    if state.size >= capacity:
        return state, False
    slot = (state.head + state.size) % capacity
    tree_map(lambda s, x: _write_slot(s, x, slot), state.storage, item)
    return state._replace(size=state.size + 1), True


def queue_pop(state: QueueState):
    """Dequeue the oldest item (FIFO): ``(state, item)``.

    The item's tensors are views of its slot, valid until a push writes
    the slot again.  Popping an empty queue returns the head slot's stale
    contents and leaves the queue empty, as the reference does.
    """
    item = tree_map(lambda s: s[state.head], state.storage)
    if state.size == 0:
        return state, item
    return state._replace(head=(state.head + 1) % queue_capacity(state),
                          size=state.size - 1), item
