"""Nested-dict parameter trees in ``jax.tree.flatten`` order.

Leaf order matters to the port: the per-leaf counter salt of the ZO noise
depends on the leaf index, so the leaves must come out in the order the
reference flattens them: dict keys sorted, recursively, and an empty dict
(OLMo's parameter-free norms) contributing no leaf.

The walks are plain recursive functions, not closures that call
themselves: such a closure forms a reference cycle with its frame, and the
cycle would hold every leaf of the tree (GBs of parameters) until the
garbage collector happens to run.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _flatten_into(t: Any, out: List[Any]) -> Any:
    if isinstance(t, dict):
        return {k: _flatten_into(t[k], out) for k in sorted(t)}
    out.append(t)
    return None


def _build(spec: Any, it: Iterator[Any]) -> Any:
    if isinstance(spec, dict):
        return {k: _build(v, it) for k, v in spec.items()}
    return next(it)


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, spec). ``spec`` mirrors the tree with None at each leaf."""
    leaves: List[Any] = []
    spec = _flatten_into(tree, leaves)
    return leaves, spec


def unflatten(spec: Any, leaves) -> Any:
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree spec holds")
    return out


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of ``tree`` (and of same-structured
    ``rest`` trees)."""
    lv, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(lv, *others)])
