"""Trees of tensors: nested dicts, lists, tuples and NamedTuples.

The port's parameters and optimizer state are such trees, where the
reference keeps JAX pytrees. Leaves are walked as JAX walks a pytree:
dict keys in sorted order, sequences in order, ``None`` an empty subtree.
So the same structure gives the same leaf order, and the checkpoint
store the same leaf names (``path_name``), in both packages.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(t) -> list:
    """[(path element, child)] of an inner node; [] for a leaf."""
    if isinstance(t, dict):
        return [(k, t[k]) for k in sorted(t)]
    if _is_namedtuple(t):
        return [(f".{f}", getattr(t, f)) for f in t._fields]
    if isinstance(t, (list, tuple)):
        return list(enumerate(t))
    return []


def _is_leaf(t) -> bool:
    return t is not None and not isinstance(t, (dict, list, tuple))


def flatten_with_path(tree) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in JAX's order; a path is the tuple of dict keys,
    ``.field`` names and sequence indices from the root."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [((), tree)]
    return [((k, *path), leaf) for k, child in _children(tree)
            for path, leaf in flatten_with_path(child)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_name(path: tuple) -> str:
    """The reference checkpoint's name of a leaf: path elements joined
    by ``_`` (``"leaf"`` for the root)."""
    return "_".join(str(p) for p in path) or "leaf"


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (of the same structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    out = [tree_map(fn, v, *(r[i] for r in rest))
           for i, v in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*out)
    return type(tree)(out)


def _build(t, it):
    """``t``'s structure with its leaves taken from the iterator ``it``."""
    if t is None:
        return None
    if _is_leaf(t):
        return next(it)
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    out = [_build(c, it) for c in t]
    return type(t)(*out) if _is_namedtuple(t) else type(t)(out)


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves``, given in
    ``leaves(like)``'s order. A module-level helper, not a recursive
    closure: a closure that calls itself is a reference cycle, which
    would keep ``new_leaves`` (a step's gradients) alive until the
    garbage collector ran."""
    return _build(like, iter(new_leaves))
