"""Nested-dict trees of tensors in the reference's leaf order.

`jax.tree.flatten` visits a dict's keys sorted and a tuple or list in
order; `leaves` does the same, so the i-th leaf here is the reference's
i-th leaf (the checkpoint layout relies on it).
"""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["leaves", "tree_map", "unflatten"]


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: Any, flat: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``flat`` (in `leaves` order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(t) for t in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
