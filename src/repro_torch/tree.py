"""Trees of tensors: nested dicts, lists, tuples and dataclasses with
tensors (or other values) at the leaves, as the port keeps parameters,
optimizer state and train state.  The counterpart of the ``jax.tree``
functions the reference uses; a leaf's path is its keys joined by ``/``
(``layers/3/ln1/scale``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple)) or (
        dataclasses.is_dataclass(tree) and not isinstance(tree, type))


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Every leaf with its path, in insertion order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += leaves_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map_with_path(fn: Callable, tree, *rest, prefix: str = ""):
    """``fn(path, leaf, *leaves of rest at the same place)`` over ``tree``'s
    leaves, rebuilt in ``tree``'s structure."""
    if not _is_node(tree):
        return fn(prefix, tree, *rest)
    kids = _children(tree)
    rest_kids = [dict(_children(r)) for r in rest]

    def sub(key, child):
        path = f"{prefix}/{key}" if prefix else key
        return tree_map_with_path(fn, child, *(r[key] for r in rest_kids),
                                  prefix=path)

    if isinstance(tree, dict):
        return {k: sub(str(k), v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(sub(k, v) for k, v in kids)
    return dataclasses.replace(tree, **{k: sub(k, v) for k, v in kids})


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over ``tree``'s leaves."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def tree_unzip(fn: Callable, n: int, tree, *rest) -> Tuple[Any, ...]:
    """``fn(path, leaf, *leaves of rest)`` returns an ``n``-tuple at every
    leaf; the result is ``n`` trees in ``tree``'s structure."""
    results = {}

    def run(path, *xs):
        results[path] = fn(path, *xs)

    tree_map_with_path(run, tree, *rest)
    return tuple(tree_map_with_path(lambda path, _, i=i: results[path][i], tree)
                 for i in range(n))
