"""Shared gridworld mechanics, batched over a leading env axis.

Port of `repro.envs.grid`: integer (row, col) grids with cardinal moves,
one-pass collision resolution and distinct-cell spawning.  Every function
takes a leading env axis ``N``; positions are int32, as in the reference,
and tables are indexed with int64.
"""
from __future__ import annotations

import functools

import torch

# action 0 = noop, 1..4 = up / down / left / right (row, col deltas)
MOVES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


@functools.cache
def _moves(device):
    return torch.tensor(MOVES, dtype=torch.int32, device=device)


def apply_moves(pos, actions, grid_size: int):
    """Proposed positions ``(N, A, 2)``: actions 1..4 move one cell, anything else stays."""
    is_move = (actions >= 1) & (actions <= 4)
    idx = torch.where(is_move, actions, 0).long()
    return torch.clamp(pos + _moves(pos.device)[idx], 0, grid_size - 1)


def hits_cells(proposed, cells, mask):
    """For each env and agent, whether its proposed cell is one of ``cells[mask]``.

    ``proposed``: ``(N, A, 2)``; ``cells``: ``(N, C, 2)``; ``mask``: ``(N, C)``.
    """
    hit = (proposed[:, :, None] == cells[:, None]).all(-1) & mask[:, None, :]
    return hit.any(-1)


def resolve_collisions(pos, proposed, blocked=None):
    """One-pass conservative collision resolution, per env.

    A move is cancelled when its target is (a) another agent's current
    cell, (b) another agent's proposed cell, or (c) statically ``blocked``
    (``(N, A)``).  Cancelling all contested moves in one pass keeps the
    no-two-agents-per-cell invariant without iterating (conservative: an
    agent cannot enter a cell being vacated this same step).
    """
    n = pos.shape[1]
    other = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    same_prop = (proposed[:, :, None] == proposed[:, None]).all(-1) & other
    into_cur = (proposed[:, :, None] == pos[:, None]).all(-1) & other
    conflict = same_prop.any(-1) | into_cur.any(-1)
    if blocked is not None:
        conflict = conflict | blocked
    return torch.where(conflict[..., None], pos, proposed)


def sample_distinct_cells(keys, grid_size: int, n: int):
    """``n`` distinct (row, col) cells per env, ``(N, n, 2)`` int32.

    ``keys``: ``(N, grid_size ** 2)`` uniform draws; the cells are the
    first ``n`` of the flat grid ordered by them, a random permutation as
    the reference's ``jax.random.permutation`` gives.
    """
    flat = torch.argsort(keys, dim=-1, stable=True)[:, :n]
    return torch.stack([flat // grid_size, flat % grid_size], dim=-1).to(torch.int32)
