"""Pytree checkpointing to .npz (port of `repro.checkpoint.ckpt`).

The on-disk format is the reference's: one ``ckpt_{step:08d}.npz`` a step,
written under a temporary name and renamed into place, its keys the tree
paths joined with ``"/"``: a dict's key, a NamedTuple's field name, a
tuple's or list's index.  The port's trees mirror the JAX pytrees
(`repro_torch.convert`), so the same `TrainState` gives the same keys in
both packages, and a checkpoint one package writes the other restores.

Leaves are tensors (copied to the host; bfloat16 widened to float32, as
the reference widens it) or Python numbers (the replay family's update
count: an int is written as the reference's int32).  `restore_checkpoint`
returns the target's structure with each tensor leaf a tensor of the
target leaf's dtype on its device (the cast goes through torch, since
numpy has no bfloat16) and each Python number a Python number.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import _is_namedtuple

_SEP = "/"


def _flatten_with_paths(tree, prefix=()):
    """``[(path, leaf)]`` in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [e for name, x in zip(tree._fields, tree)
                for e in _flatten_with_paths(x, prefix + (name,))]
    if isinstance(tree, (tuple, list)):
        return [e for i, x in enumerate(tree) for e in _flatten_with_paths(x, prefix + (str(i),))]
    if tree is None:
        return []
    return [(_SEP.join(prefix), tree)]


def _to_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:  # numpy has no bfloat16; widen, as the reference does
            leaf = leaf.float()
        return leaf.cpu().numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)  # the reference's int32 update count
    if isinstance(leaf, (float, np.ndarray, np.generic)):
        return np.asarray(leaf)
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Write ``tree`` as ``<directory>/ckpt_{step:08d}.npz`` (atomically); return the path."""
    os.makedirs(directory, exist_ok=True)
    flat = {key: _to_array(leaf) for key, leaf in _flatten_with_paths(tree)}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"  # np.savez appends .npz unless present
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The highest step with a checkpoint in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", name))]
    return max(steps) if steps else None


def _restore_leaf(val: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(val)).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, bool):
        return bool(val)
    if isinstance(leaf, int):
        return int(val)
    if isinstance(leaf, float):
        return float(val)
    return np.asarray(val, dtype=np.asarray(leaf).dtype)


def _unflatten(tree, values, prefix=()):
    """``tree`` with each leaf replaced by ``values[path]``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, prefix + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(x, values, prefix + (name,))
                            for name, x in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(x, values, prefix + (str(i),)) for i, x in enumerate(tree))
    if tree is None:
        return None
    return values[_SEP.join(prefix)]


def restore_checkpoint(directory: str, step: int, target_tree):
    """Restore into the structure of ``target_tree`` (its values replaced).

    Raises `KeyError` when the checkpoint lacks a leaf of the target.
    """
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        values = {}
        for key, leaf in _flatten_with_paths(target_tree):
            if key not in data:
                raise KeyError(f"checkpoint missing key {key!r}")
            values[key] = _restore_leaf(data[key], leaf)
    return _unflatten(target_tree, values)
