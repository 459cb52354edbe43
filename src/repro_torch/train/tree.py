"""Trees of tensors: the port's counterpart of the reference's pytrees.

A tree is nested dicts, lists, tuples and named tuples (``OptState``)
with tensors (or numpy arrays, or numbers) at the leaves; ``None`` holds
no leaf. Leaves come in ``jax.tree_util``'s order: a dict's keys sorted,
a sequence's items in order. A leaf's path names each step as
``jax.tree_util.tree_flatten_with_path`` does: a dict key, a sequence
index, and for a ``NamedTuple`` field ``"." + name`` (JAX's
``GetAttrKey`` prints so), which is what makes a checkpoint's leaf keys
the reference's (``opt|.mu|embed``).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence, Tuple

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _rebuild(tree: PyTree, fn: Callable, path: tuple) -> PyTree:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, the leaves
    visited in flatten order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {key: _rebuild(tree[key], fn, path + (key,))
               for key in sorted(tree)}
        return {key: new[key] for key in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, fn, path + ("." + name,))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_flatten_with_path(tree: PyTree) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in flatten order."""
    out: List[Tuple[tuple, Any]] = []
    _rebuild(tree, lambda path, leaf: out.append((path, leaf)), ())
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(template: PyTree, leaves: Sequence[Any]) -> PyTree:
    """``template``'s structure with ``leaves`` (in flatten order) at its
    leaves."""
    it: Iterator = iter(leaves)
    out = _rebuild(template, lambda path, leaf: next(it), ())
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree``, in its structure."""
    return _rebuild(tree, lambda path, leaf: fn(leaf), ())


def path_key(path: tuple) -> str:
    """A leaf's path as the reference's checkpoint joins it (``"|"``)."""
    return "|".join(str(p) for p in path)


def subtree(tree: PyTree, path: tuple) -> PyTree:
    """The node of ``tree`` at ``path`` (a path of
    :func:`tree_flatten_with_path` over a tree of the same structure)."""
    for p in path:
        if isinstance(p, str) and p.startswith(".") and _is_namedtuple(tree):
            tree = getattr(tree, p[1:])
        else:
            tree = tree[p]
    return tree
