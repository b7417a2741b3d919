"""Nested dicts and lists of tensors as trees, flattened in JAX's order.

`jax.tree_util.tree_flatten` visits a dict's keys sorted and a list's
items in order; `leaves` does the same, so a checkpoint's `leaf_i` and an
optimizer's leaf order are the reference's. `None` is an empty subtree, as
in JAX; anything else that is not a dict or a list is a leaf.
"""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of `tree`, depth first, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in leaves(item)]
    return [] if tree is None else [tree]


def unflatten(like, values) -> object:
    """A tree shaped like `like` holding `values` in `leaves` order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(item) for item in node]
        return None if node is None else next(it)
    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn, tree, *rest) -> object:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest), strict=True)])
