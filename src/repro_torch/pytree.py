"""Nested parameter trees (dicts, lists, tuples and ``None`` over tensors)
in the reference's pytree order.

JAX flattens a dict by its sorted keys, a list or tuple by index, and
holds no leaf for ``None``; the port's dicts keep their insertion order.
The port walks every tree here, so its leaves pair with the reference's
wherever they meet (the train step's stacked leaves and flat snapshot
buffers, the checkpoint's ``leaf_i``), and the model's stacked body and
cycle views come out in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch

Tree = Any


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves``' order."""
    return list(_walk(tree))


def leaves_with_paths(tree: Tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in ``leaves``' order, each path the dict keys
    and list or tuple indices from the root joined by ``/`` (the
    reference's ``sharding._path_str`` of
    ``jax.tree_util.tree_flatten_with_path``'s path)."""
    return list(_walk_paths(tree, ()))


def _walk_paths(tree: Tree, path: Tuple[str, ...]
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_paths(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def leaves_like(tree: Tree, like: Tree) -> List[Any]:
    """The entries of ``tree`` at the places of ``like``'s leaves, in
    ``leaves``' order: the leaves of a tree whose own leaves may be
    containers (``sharding``'s spec tuples) by its tensor twin."""
    return list(_walk_like(tree, like))


def _walk_like(tree: Tree, like: Tree) -> Iterator[Any]:
    if like is None:
        return
    if isinstance(like, dict):
        for k in sorted(like):
            yield from _walk_like(tree[k], like[k])
    elif isinstance(like, (list, tuple)):
        for t, v in zip(tree, like):
            yield from _walk_like(t, v)
    else:
        yield tree


def _walk(tree: Tree) -> Iterator[torch.Tensor]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def unflatten(like: Tree, new: List[Any]) -> Tree:
    """A tree of ``like``'s structure (dicts in its key order) whose
    leaves are ``new``, taken in ``leaves``' order."""
    it = iter(new)
    out = _fill(like, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def _fill(like: Tree, it: Iterator) -> Tree:
    if like is None:
        return None
    if isinstance(like, dict):
        filled = {k: _fill(like[k], it) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, it) for v in like)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("unflatten: fewer leaves than the tree holds") \
            from None


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` on each leaf of ``tree`` and the leaves at the same place in
    ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*args) for args in
                            zip(leaves(tree), *others)])


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's name as NumPy (and JAX's ``str(array.dtype)``)
    prints it: ``"bfloat16"``, ``"float32"``, ``"int32"``, ``"bool"``."""
    return str(dtype).rsplit(".", 1)[-1]


def treedef_str(tree: Tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))``: ``PyTreeDef(...)``
    with a dict's keys sorted, ``*`` for a leaf, ``None``, ``[...]`` and
    ``(...)``."""
    return f"PyTreeDef({_def(tree)})"


def _def(tree: Tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_def(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_def(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_def(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"
