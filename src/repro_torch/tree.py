"""Parameter trees: nested dicts, lists and NamedTuples of tensors, as the
port keeps its parameters, gradients and optimizer state (the counterpart
of JAX pytrees for the few operations the port needs)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in traversal order; paths are '/'-joined keys."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += leaves_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def _build(t, it):
    if _is_leaf(t):
        return next(it)
    if isinstance(t, dict):
        return {k: _build(v, it) for k, v in t.items()}
    if hasattr(t, "_fields"):
        return type(t)(*(_build(v, it) for v in t))
    return type(t)(_build(v, it) for v in t)


def unflatten(template, new_leaves) -> Any:
    """A tree shaped like ``template`` holding ``new_leaves`` in order
    (built without a recursive closure, whose reference cycle would keep
    ``new_leaves`` alive until the garbage collector runs)."""
    it = iter(new_leaves)
    out = _build(template, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn applied leaf-wise over trees of the same structure."""
    flat = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
