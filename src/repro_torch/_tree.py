"""Parameter and state trees as the reference's ``jax.tree_util`` sees them.

A tree is nested dicts, NamedTuples, lists and tuples with tensors (or
other objects) at the leaves; ``None`` holds no leaf.  Leaves come in JAX's
flatten order: a dict's children by sorted key, a NamedTuple's and a
sequence's in order.  So a sum over the leaves adds in the reference's
order, and a checkpoint names each leaf by the reference's key path: a dict
key as itself, a NamedTuple field as ``.name`` (how JAX renders a
``GetAttrKey``), a sequence index as its number.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

__all__ = ["tree_leaves", "tree_map", "tree_flatten_with_path", "tree_unflatten"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_flatten_with_path(tree, is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(key path, leaf), ...]`` in flatten order; ``is_leaf`` marks nodes
    to keep whole (a spec's tuple of axis names, a ``NamedSharding``)."""
    out: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(node, path):
        if node is None:
            return
        if is_leaf is not None and is_leaf(node):
            out.append((path, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif _is_namedtuple(node):
            for name, child in zip(node._fields, node):
                walk(child, path + ("." + name,))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def tree_leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree, is_leaf)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in flatten order)."""
    it: Iterator[Any] = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(child) for child in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable[..., Any], tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    flat = [tree_leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("tree_map: the trees hold different numbers of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])
