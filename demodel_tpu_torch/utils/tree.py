"""Params trees: nested dicts and lists (or tuples) of tensors, the port's
stand-in for ``jax.tree``. Dict keys keep their insertion order, so two
trees built the same way flatten leaf for leaf alike."""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The leaves of ``tree``, depth first."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` applied leaf by leaf across ``tree`` and the trees in
    ``rest`` (each of ``tree``'s structure), in a tree of that
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, flat) -> Any:
    """The leaves ``flat`` (in :func:`leaves` order) in ``like``'s
    structure."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)
