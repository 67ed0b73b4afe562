"""Carry weights and state between the JAX package and the port.

`params_from_jax` turns a tree of arrays (numpy arrays, or anything
`numpy.asarray` accepts, such as JAX arrays) into a tree of tensors;
`params_to_jax` turns tensors back into numpy arrays, which JAX functions
accept as they are.  Dicts, lists and tuples keep their type.  A
NamedTuple of the reference (``TrainState``, ``AdamState``, ``Carry``,
``Transition``, ...) becomes the port's NamedTuple of the same name, found
by name so this module never imports the reference; NamedTuples of the
port keep their type on the way back.  Both packages store ``w`` as
``(in, out)``, so no leaf is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Carry, EvalMetrics, SystemState, TrainState, Transition
from repro_torch.optim.optimizers import AdamState

NAMEDTUPLES = {
    cls.__name__: cls
    for cls in (AdamState, Carry, EvalMetrics, SystemState, TrainState, Transition)
}


def _convert(tree, leaf, named):
    if isinstance(tree, dict):
        return {k: _convert(v, leaf, named) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = named(type(tree))
        return cls(*(_convert(x, leaf, named) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(x, leaf, named) for x in tree)
    if tree is None:
        return None
    return leaf(tree)


def _port_namedtuple(cls):
    try:
        return NAMEDTUPLES[cls.__name__]
    except KeyError:
        raise TypeError(f"no port counterpart for NamedTuple {cls.__name__}") from None


def params_from_jax(tree, device="cpu"):
    """A tree of arrays -> the same tree of tensors on ``device``."""
    return _convert(
        tree,
        lambda x: torch.from_numpy(np.array(x)).to(device),
        _port_namedtuple,
    )


def params_to_jax(tree):
    """A tree of tensors -> the same tree of numpy arrays (on the host)."""
    return _convert(tree, lambda x: x.detach().cpu().numpy(), lambda cls: cls)
