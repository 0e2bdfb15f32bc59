"""Nested-dict parameter trees, the port's stand-in for ``jax.tree``:
containers are dicts, lists and tuples; everything else is a leaf."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of ``tree`` in the order of :func:`tree_map`;
    a path joins the dict keys and sequence indices above the leaf with '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def tree_leaves(tree) -> Iterator[Any]:
    """The leaves of ``tree`` in the order of :func:`tree_map`."""
    return (leaf for _, leaf in tree_items(tree))


def tree_unflatten(like, leaves: Iterable):
    """A tree of ``like``'s structure holding ``leaves`` in the order of
    :func:`tree_leaves`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
