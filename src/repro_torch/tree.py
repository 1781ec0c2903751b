"""Nested dicts of tensors: the port's pytrees.

The reference keeps parameters, optimizer state and batches as pytrees of
nested dicts; the port keeps the same layout as plain dicts of tensors.
Leaves are visited in sorted-key order, the order in which the
reference's tree utilities flatten a dict, so a flat list of leaves lines
up across the two packages (the captured train step's buffers, the
checkpoint files).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_paths(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(keys, leaf)`` for every leaf, in sorted-key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    """The leaves in sorted-key order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *others)`` over ``tree``'s leaves; each tree in ``rest``
    has at least ``tree``'s structure, and the part of it at a leaf of
    ``tree`` (a leaf or a whole subtree) is passed as it is."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def flatten_up_to(tree, other) -> list:
    """The parts of ``other`` at ``tree``'s leaves (a leaf, or a whole
    subtree such as an int8 moment's ``{"q", "scale"}``), in sorted-key
    order."""
    if isinstance(tree, dict):
        return [part for key in sorted(tree)
                for part in flatten_up_to(tree[key], other[key])]
    return [other]


def unflatten(tree, flat) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``flat`` in
    sorted-key order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {key: build(t[key]) for key in sorted(t)}
        return next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
