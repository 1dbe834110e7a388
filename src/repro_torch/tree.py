"""Nested dicts and lists of tensors — the port's parameter, gradient
and optimizer-state trees — walked in one fixed order: a dict's keys in
insertion order, a list's entries in index order."""

from __future__ import annotations

from typing import Any


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def paths(tree: Any, prefix: str = "") -> list[str]:
    """Each leaf's path, its keys and indices joined by "/", in the
    order of ``leaves``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [prefix]
    return [p for k, v in items
            for p in paths(v, f"{prefix}/{k}" if prefix else str(k))]


def rebuild(tree: Any, new_leaves: list) -> Any:
    """``tree``'s structure with ``new_leaves`` (in the order of
    ``leaves``) in place of its own."""
    it = iter(new_leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    out = walk(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
