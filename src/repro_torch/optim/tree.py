"""Parameter trees: the nested containers ``jax.tree`` walks, for torch.

A tree is a dict (walked in sorted key order, as ``jax.tree`` walks
one), a list, a tuple or a NamedTuple of trees; anything else is a leaf.
The port's model parameters are such trees — nested dicts with
``params["layers"]`` a list of per-layer dicts — and so are the
optimizer's moments and the ``TrainState`` that holds them.
"""

from __future__ import annotations

from typing import Any, Callable


def is_namedtuple(x) -> bool:
    """Whether ``x`` is a NamedTuple (a tree node with named fields)."""
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``
    (same structure), in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            filled = {k: build(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


__all__ = ["is_namedtuple", "tree_leaves", "tree_map", "tree_unflatten"]
