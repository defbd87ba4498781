"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Leaves are visited in sorted-key order, the order ``jax.tree.leaves``
uses for dicts, so a tree and its JAX counterpart flatten alike.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf (in sorted-key order) to trees of the
    same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``tree`` holding ``leaves`` (in the order of
    :func:`tree_leaves`)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
