"""Nested dicts of tensors (parameter, optimizer and checkpoint trees),
walked in sorted-key order: the order in which the reference's pytrees
flatten a dict, so a leaf's index and its ``a/b/c`` path name agree with
the reference's."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple

Tree = Dict[str, Any]


def items(tree: Tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in sorted-key order."""
    for key in sorted(tree):
        sub = f"{path}/{key}" if path else key
        if isinstance(tree[key], dict):
            yield from items(tree[key], sub)
        else:
            yield sub, tree[key]


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in items(tree)]


def map_tree(fn: Callable, tree: Tree, *others: Tree, path: str = "") -> Tree:
    """``fn(path, leaf, *other_leaves)`` over ``tree``'s leaves, into a
    tree of the same structure (``others`` share it)."""
    out = {}
    for key in sorted(tree):
        sub = f"{path}/{key}" if path else key
        rest = [t[key] for t in others]
        if isinstance(tree[key], dict):
            out[key] = map_tree(fn, tree[key], *rest, path=sub)
        else:
            out[key] = fn(sub, tree[key], *rest)
    return out


def like(tree: Tree, new_leaves) -> Tree:
    """``tree``'s structure over ``new_leaves``, given in `items` order."""
    it = iter(new_leaves)
    return map_tree(lambda *_: next(it), tree)
