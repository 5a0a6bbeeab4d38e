"""Parameter and state trees in ``jax.tree.flatten`` order.

Leaf order matters to the port: the per-leaf counter salt of the ZO noise
depends on the leaf index, so the leaves must come out in the order the
reference flattens them: dict keys sorted, recursively, and an empty dict
(OLMo's parameter-free norms) contributing no leaf. One walk serves every
function here. ``flatten``, ``leaves`` and ``tree_map`` treat anything but
a dict as a leaf (parameter trees are nested dicts); ``path_leaves`` and
``replace_leaves`` also walk NamedTuples, tuples and lists and skip None
(the engine's state, such as GAS's), naming each leaf by its jax tree
path.

The walks are plain recursive functions, not closures that call
themselves: such a closure forms a reference cycle with its frame, and the
cycle would hold every leaf of the tree (GBs of parameters) until the
garbage collector happens to run.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(t: Any, path: Tuple[str, ...], out: List[Tuple[str, Any]],
          deep: bool) -> None:
    """Append t's (path, leaf) pairs to ``out`` in jax's flatten order:
    dict keys sorted and bare; with ``deep``, NamedTuple fields as
    '.field', sequence indices bare, and None holding no leaf."""
    if isinstance(t, dict):
        items = [(str(k), t[k]) for k in sorted(t)]
    elif deep and t is None:
        return
    elif deep and _is_namedtuple(t):
        items = [("." + f, getattr(t, f)) for f in t._fields]
    elif deep and isinstance(t, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(t)]
    else:
        out.append(("/".join(path), t))
        return
    for k, v in items:
        _walk(v, path + (k,), out, deep)


def _build(like: Any, it: Iterator[Any], deep: bool) -> Any:
    """``like``'s structure (dicts in sorted key order) with its leaves, in
    ``_walk``'s order, taken from ``it``."""
    if isinstance(like, dict):
        return {k: _build(like[k], it, deep) for k in sorted(like)}
    if deep and like is None:
        return None
    if deep and _is_namedtuple(like):
        return type(like)(*[_build(getattr(like, f), it, deep)
                            for f in like._fields])
    if deep and isinstance(like, (list, tuple)):
        return type(like)(_build(v, it, deep) for v in like)
    return next(it)


def _rebuild(like: Any, leaves, deep: bool) -> Any:
    it = iter(leaves)
    out = _build(like, it, deep)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def leaves(tree: Any) -> List[Any]:
    out: List[Tuple[str, Any]] = []
    _walk(tree, (), out, False)
    return [leaf for _, leaf in out]


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, spec); ``unflatten(spec, leaves)`` rebuilds the tree. The
    spec is the tree itself: only its structure is read."""
    return leaves(tree), tree


def unflatten(spec: Any, leaves) -> Any:
    return _rebuild(spec, leaves, False)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of ``tree`` (and of same-structured
    ``rest`` trees)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])


def path_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in jax's flatten order, each path as jax's tree
    paths print through ``repro.ckpt``: dict keys (sorted) and sequence
    indices bare, NamedTuple fields as '.field', joined with '/'. None and
    empty containers hold no leaf."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, (), out, True)
    return out


def replace_leaves(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves, in ``path_leaves`` order,
    replaced by ``leaves``."""
    return _rebuild(like, leaves, True)
