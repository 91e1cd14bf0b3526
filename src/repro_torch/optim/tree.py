"""The few pytree operations the training path needs, over nested dicts,
tuples and lists of tensors (``OptState`` is a tuple).

Dicts flatten in sorted-key order and sequences in order, as
``jax.tree_util`` flattens them; ``None`` holds no leaf.  So the port's
leaves line up one for one with the JAX package's for the same tree: in the
parity tests, and in a checkpoint's ``arr_%05d.npy`` files.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The tree's leaves in flattening order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in leaves(x)]
    if tree is None:
        return []
    return [tree]


def unflatten(proto, flat: list):
    """A tree shaped like ``proto`` holding ``flat`` (in flattening order)."""
    it = iter(flat)
    out = _rebuild(proto, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the prototype holds")
    return out


_END = object()


def _rebuild(proto, it):
    if isinstance(proto, dict):
        return {k: _rebuild(proto[k], it) for k in sorted(proto)}
    if isinstance(proto, tuple) and hasattr(proto, "_fields"):  # NamedTuple
        return type(proto)(*(_rebuild(x, it) for x in proto))
    if isinstance(proto, (tuple, list)):
        return type(proto)(_rebuild(x, it) for x in proto)
    if proto is None:
        return None
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the prototype holds")
    return leaf


def subtrees(proto, tree) -> list:
    """``tree``'s subtrees at the leaf positions of ``proto`` (JAX's
    ``treedef.flatten_up_to``): a per-parameter state for each parameter."""
    if isinstance(proto, dict):
        return [s for k in sorted(proto) for s in subtrees(proto[k], tree[k])]
    if isinstance(proto, (tuple, list)):
        return [s for p, t in zip(proto, tree) for s in subtrees(p, t)]
    if proto is None:
        return []
    return [tree]


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 (jax.tree.map's name)
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a tree of the same shape."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *(leaves(r) for r in rest))])


__all__ = ["leaves", "unflatten", "subtrees", "map"]
