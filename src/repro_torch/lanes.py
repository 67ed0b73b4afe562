"""Seed lanes: several independent training runs batched into one.

The reference trains ``num_seeds`` runs as one program by `jax.vmap` over
per-seed keys.  The port batches them instead: the seed axis becomes one
more leading batch axis of every tensor, so each device op serves every
run at once.  The conventions, used by the runner, the systems and the
evaluator:

* randomness comes from a tuple of generators (`torch.Generator`), one
  per lane, each seeded with its run's seed; a lane draws from its own
  generator in the order a single run would, so lane ``s`` is the run
  with seed ``s``;
* parameters, optimizer state and update metrics lead with the lane axis
  ``(S, ...)``;
* what is indexed by env copy has the batch shape ``(S, N)``: the lane
  axis sits just before the env axis (rollout storage is time-major,
  ``(T, S, N, ...)``);
* the envs themselves see the ``S * N`` copies as one flat batch, lane
  after lane (`merge` and `split` move between the two views).

A single run is the same code with no lane axis and one generator.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def count(generator):
    """The number of lanes a generator argument drives, or None for a single run."""
    return len(generator) if isinstance(generator, tuple) else None


def device(generator):
    """The device a generator (or the first of a tuple of lane generators) draws on."""
    return (generator[0] if isinstance(generator, tuple) else generator).device


def generators(seeds, device) -> tuple:
    """One `torch.Generator` on ``device`` per seed, seeded with it."""
    return tuple(torch.Generator(device).manual_seed(int(s)) for s in seeds)


def _draw(fn, generator, shape):
    """``fn(shape, generator)``, or with lane generators one draw of ``shape[0] // S`` rows a lane."""
    lanes = count(generator)
    if lanes is None:
        return fn(shape, generator)
    if shape[0] % lanes:
        raise ValueError(f"{shape[0]} rows do not split into {lanes} lanes")
    rows = (shape[0] // lanes, *shape[1:])
    return torch.cat([fn(rows, g) for g in generator])


def rand(generator, shape, device):
    """Uniform [0, 1) draws of ``shape``.

    With a tuple of lane generators, ``shape[0]`` splits evenly into the
    lanes, and each lane's rows come from its own generator: the numbers
    that lane's single run draws for its ``shape[0] // S`` rows.  `randn`
    and `randint` split the same way.
    """
    return _draw(lambda s, g: torch.rand(s, generator=g, device=device), generator, shape)


def randn(generator, shape, device):
    """Standard normal draws of ``shape`` (lanes as in `rand`)."""
    return _draw(lambda s, g: torch.randn(s, generator=g, device=device), generator, shape)


def randint(generator, high: int, shape, device):
    """Uniform integers in ``[0, high)`` of ``shape`` (int64; lanes as in `rand`)."""
    return _draw(lambda s, g: torch.randint(high, s, generator=g, device=device), generator,
                 shape)


def randperm(n: int, generator):
    """A permutation of ``n`` per lane: ``(n,)``, or ``(S, n)`` for lane generators."""
    lanes = count(generator)
    if lanes is None:
        return torch.randperm(n, generator=generator, device=generator.device)
    return torch.stack([torch.randperm(n, generator=g, device=g.device) for g in generator])


def split(tree, lanes):
    """Env view ``(S * N, ...)`` -> lane view ``(S, N, ...)`` of every tensor in ``tree``.

    The identity without lanes; leaves that are not tensors (generators)
    are kept.
    """
    if lanes is None:
        return tree
    return tree_map(
        lambda x: x.unflatten(0, (lanes, -1)) if isinstance(x, torch.Tensor) else x, tree
    )


def merge(tree, lanes):
    """Lane view ``(S, N, ...)`` -> env view ``(S * N, ...)`` (identity without lanes)."""
    if lanes is None:
        return tree
    return tree_map(lambda x: x.flatten(0, 1), tree)


def stack(trees):
    """Per-lane trees -> one tree whose leaves lead with the lane axis.

    A leaf that is not a tensor (a host-side count such as the replay
    family's ``TrainState.steps``) is the same in every lane and stays
    one value.
    """

    def one(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        if any(x != xs[0] for x in xs):
            raise ValueError(f"host-side leaves differ between lanes: {xs}")
        return xs[0]

    return tree_map(one, *trees)
