"""Gradient-transformation optimizers (port of `repro.optim.optimizers`).

An `Optimizer` is a pair of functions over pytrees of tensors, written as
the reference writes them rather than through `torch.optim`:

  init(params) -> state
  update(grads, state, params) -> (updates, new_state)

and `apply_updates(params, updates)` adds the updates.
`clip_adamw_in_place` is ``chain(clip_by_global_norm, adamw)``'s update
and `apply_updates` in one pass over the leaves, in place: the same
arithmetic, with the memory of the parameters, gradients and moments and
one leaf's temporaries (the reference gets the same from XLA by donating
the parameters and optimizer state to its jitted step).  Two reference
defaults differ from PyTorch's own: `adamw` defaults to
``weight_decay=0.0`` (``torch.optim.AdamW``: 0.01), and
`clip_by_global_norm` divides by ``norm + 1e-9``
(``torch.nn.utils.clip_grad_norm_``: ``+ 1e-6``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    """An ``(init, update)`` pair of gradient transformations."""

    init: Callable
    update: Callable


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of all leaves of ``tree`` together, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def apply_updates(params, updates):
    """``params + updates`` leafwise, in each param's dtype."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Scale all gradients by ``min(1, max_norm / (norm + 1e-9))``."""

    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        del params
        factor = _clip_factor(grads, max_norm)
        return tree_map(lambda g: _clip(g, factor), grads), state

    return Optimizer(init, update)


def _clip_factor(grads, max_norm):
    return torch.clamp(max_norm / (global_norm(grads) + 1e-9), max=1.0)


def _clip(g, factor):
    # JAX promotes a bfloat16 gradient times the float32 factor to float32;
    # PyTorch would keep bfloat16 (a 0-dim operand does not promote), so
    # promote by hand
    return g.to(torch.promote_types(g.dtype, factor.dtype)) * factor


class AdamState(NamedTuple):
    """Adam's step count and first/second moment trees."""

    count: Any
    mu: Any
    nu: Any


def adamw(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Adam with decoupled weight decay (off by default, as in the reference)."""

    def init(params):
        mu = tree_map(torch.zeros_like, params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device), mu, nu)

    def update(grads, state, params):
        count = state.count + 1
        mu = tree_map(lambda m, g: _first_moment(m, g, b1), state.mu, grads)
        nu = tree_map(lambda v, g: _second_moment(v, g, b2), state.nu, grads)
        bc = _bias_corrections(count, b1, b2)
        return (tree_map(lambda m, v, p: _adam_update(m, v, p, bc, learning_rate, eps,
                                                      weight_decay), mu, nu, params),
                AdamState(count, mu, nu))

    return Optimizer(init, update)


def _first_moment(m, g, b1):
    return b1 * m + (1 - b1) * g.to(m.dtype)


def _second_moment(v, g, b2):
    return b2 * v + (1 - b2) * torch.square(g.float())


def _bias_corrections(count, b1, b2):
    c = count.float()
    return 1 - b1**c, 1 - b2**c


def _adam_update(m, v, p, bc, learning_rate, eps, weight_decay):
    step = (m.float() / bc[0]) / (torch.sqrt(v / bc[1]) + eps)
    if weight_decay:
        step = step + weight_decay * p.float()
    return (-learning_rate * step).to(p.dtype)


@torch.no_grad()
def clip_adamw_in_place(params, grads, state, max_norm: float, learning_rate: float,
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                        weight_decay: float = 0.0):
    """``chain(clip_by_global_norm(max_norm), adamw(...))``'s update applied to
    ``params``, leaf by leaf and in place.

    ``state`` is that chain's state, ``((), AdamState)``; its moment tensors
    are overwritten with the new moments, and the returned state holds them
    beside the new count.  Each leaf's value is what `update` and then
    `apply_updates` give.
    """
    clip_state, adam = state
    factor = _clip_factor(grads, max_norm)
    count = adam.count + 1
    bc = _bias_corrections(count, b1, b2)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(adam.mu),
                          tree_leaves(adam.nu)):
        g = _clip(g, factor)
        m.copy_(_first_moment(m, g, b1))
        v.copy_(_second_moment(v, g, b2))
        p.add_(_adam_update(m, v, p, bc, learning_rate, eps, weight_decay))
    return clip_state, AdamState(count, adam.mu, adam.nu)


def chain(*transforms: Optimizer) -> Optimizer:
    """Apply ``transforms`` in order; the state is the tuple of their states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Optimizer(init, update)
