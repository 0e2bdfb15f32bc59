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


def jax_items(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs of ``tree`` in ``jax.tree.flatten``'s order,
    the order of the reference's checkpoint files: dict keys sorted,
    sequences (named tuples too) in order, ``None`` an empty subtree with
    no leaf.  Paths as in :func:`tree_items`."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [it for k in sorted(tree) for it in jax_items(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [it for i, c in enumerate(tree) for it in jax_items(c, f"{prefix}/{i}")]
    return [(prefix, tree)]


def jax_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order (:func:`jax_items`)."""
    return [leaf for _, leaf in jax_items(tree)]


_END = object()


def jax_unflatten(like, leaves: Iterable):
    """A tree of ``like``'s structure holding ``leaves`` in the order of
    :func:`jax_leaves`; ``None`` subtrees stay ``None``.  Raises
    ``ValueError`` when the count of leaves differs from ``like``'s."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            filled = {k: build(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if isinstance(t, (list, tuple)):
            children = [build(c) for c in t]
            return type(t)(*children) if hasattr(t, "_fields") else type(t)(children)
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree holds") from None

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out
