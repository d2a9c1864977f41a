"""Nested dicts of tensors, walked in ``jax.tree.flatten``'s order.

The port's parameter, gradient and optimizer trees are plain nested dicts.
Wherever leaves are paired up or written out (the optimizer pairs each
gradient with its moments and master; the checkpoint store writes leaf
``a{i}``), they are taken in the order the reference's pytrees give: dict
keys sorted, recursively.  That order is what lets each package restore the
other's checkpoints.
"""

from __future__ import annotations

from typing import Any, Callable


def named_leaves(tree: dict, prefix: str = "") -> list[tuple[str, Any]]:
    """(``"a/b"`` path, leaf) pairs, keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += named_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def leaves(tree: dict) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def rebuild(tree: dict, new_leaves) -> dict:
    """A tree of ``tree``'s structure holding ``new_leaves`` in :func:`leaves`' order."""
    it = iter(new_leaves)

    def go(t: dict) -> dict:
        return {k: go(t[k]) if isinstance(t[k], dict) else next(it) for k in sorted(t)}

    return go(tree)


def tree_map(fn: Callable, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}
