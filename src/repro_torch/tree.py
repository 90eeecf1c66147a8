"""Nested dicts, tuples and lists of tensors (the reference's pytrees).

Flattening visits dict keys in sorted order, as ``jax.tree_util`` does,
so leaf ``i`` of a port tree is leaf ``i`` of the reference's tree with
the same structure (the KV store names blob columns by leaf index).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves_with_path(tree, prefix: Tuple = ()
                          ) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) in the order ``jax.tree_util`` flattens: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from tree_leaves_with_path(x, prefix + (i,))
    else:
        yield prefix, tree


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, spec); ``tree_unflatten(spec, leaves)`` rebuilds."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, specs = [], []
        for k in keys:
            lv, sp = tree_flatten(tree[k])
            leaves += lv
            specs.append(sp)
        return leaves, ("dict", keys, specs)
    if isinstance(tree, (tuple, list)):
        leaves, specs = [], []
        for x in tree:
            lv, sp = tree_flatten(x)
            leaves += lv
            specs.append(sp)
        return leaves, (type(tree), None, specs)
    return [tree], None


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(spec, leaves):
    return _build(spec, iter(leaves))


def _build(sp, it):
    """The tree of ``sp`` from the iterator ``it`` of its leaves: a
    module-level function, since a nested one that calls itself sits in
    a reference cycle with its closure, which would keep ``leaves`` (a
    step's whole parameters) alive until the garbage collector runs."""
    if sp is None:
        return next(it)
    kind, keys, specs = sp
    if kind == "dict":
        return {k: _build(s, it) for k, s in zip(keys, specs)}
    return kind(_build(s, it) for s in specs)
