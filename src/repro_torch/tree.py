"""Minimal pytree helpers over dicts, tuples, lists and NamedTuples.

The port keeps the JAX package's containers (nested dicts of parameters,
NamedTuple states), so it needs `jax.tree_util`'s two workhorses.  Dict
leaves are visited in sorted-key order, as JAX flattens them; ``None``
and empty containers are structure, not leaves.
"""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and same-structured ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(
            *(tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree))
        )
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)
        )
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if tree is None:
        return []
    return [tree]
