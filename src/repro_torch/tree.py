"""Trees of tensors: nested dicts, NamedTuples, lists and tuples, walked in
the order ``jax.tree_util`` gives their leaves, so that a params dict, an
``AdamWState`` or a checkpoint's ``{"params", "opt"}`` lines up leaf by
leaf with the reference's.

Dict keys are sorted; NamedTuple fields and sequence items keep their
order; None is an empty subtree. A leaf's path is the tuple of its keys
as ``tree_flatten_with_path`` prints them: ``['k']`` for a dict key,
``.f`` for a NamedTuple field, ``[i]`` for a sequence item.
"""
from __future__ import annotations

from typing import Callable, Iterable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in ``tree_flatten_with_path`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_with_path(tree[k], path + (f"[{k!r}]",))]
    if _is_namedtuple(tree):
        return [pl for f in tree._fields
                for pl in flatten_with_path(getattr(tree, f),
                                            path + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten_with_path(v, path + (f"[{i}]",))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_unflatten(like, leaves: Iterable):
    """``like``'s structure with its leaves replaced by ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    # ``build`` refers to itself through its closure cell, a cycle that
    # would keep ``leaves`` (a step's gradients) alive until the garbage
    # collector runs; emptying the cell breaks it
    del build
    return out


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    return tree_unflatten(tree, map(fn, tree_leaves(tree)))
