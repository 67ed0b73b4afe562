"""Gradient-transformation optimizers (port of `repro.optim.optimizers`).

An `Optimizer` is a pair of functions over pytrees of tensors, written as
the reference writes them rather than through `torch.optim`:

  init(params) -> state
  update(grads, state, params) -> (updates, new_state)

and `apply_updates(params, updates)` adds the updates.  Two reference
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
        norm = global_norm(grads)
        factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
        # JAX promotes a bfloat16 gradient times the float32 factor to
        # float32; PyTorch would keep bfloat16 (a 0-dim operand does not
        # promote), so promote by hand
        return tree_map(
            lambda g: g.to(torch.promote_types(g.dtype, factor.dtype)) * factor, grads
        ), state

    return Optimizer(init, update)


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
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(m.dtype), state.mu, grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state.nu, grads
        )
        c = count.float()
        bc1 = 1 - b1**c
        bc2 = 1 - b2**c

        def upd(m, v, p):
            step = (m.float() / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-learning_rate * step).to(p.dtype)

        return tree_map(upd, mu, nu, params), AdamState(count, mu, nu)

    return Optimizer(init, update)


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
