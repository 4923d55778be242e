"""Nested containers of leaves, flattened in the reference's order.

The reference flattens state with ``jax.tree_util``, which walks a dict in
*sorted key* order; ``torch.utils._pytree`` keeps insertion order.  A
checkpoint names its leaves by position (``leaf_<i>``), so both packages
must walk a tree alike: dicts by sorted key, lists and tuples (named ones
too) in order, ``None`` as an empty subtree, anything else a leaf (or
whatever ``is_leaf`` accepts, checked first).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten``'s order."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k],
                                                               is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in flatten(x, is_leaf)]
    if tree is None:
        return []
    return [tree]


def flatten_with_path(tree: Any, is_leaf: IsLeaf = None,
                      path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) of every leaf, in `flatten`'s order: dict keys and
    list / tuple indices from the root down."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_path(tree[k], is_leaf, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in flatten_with_path(x, is_leaf, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def _rebuild(like: Any, it: Iterator, is_leaf: IsLeaf) -> Any:
    if is_leaf is not None and is_leaf(like):
        return next(it)
    if isinstance(like, dict):
        done = {k: _rebuild(like[k], it, is_leaf) for k in sorted(like)}
        return type(like)((k, done[k]) for k in like)
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(x, it, is_leaf) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, it, is_leaf) for x in like)
    if like is None:
        return None
    return next(it)


def unflatten(like: Any, leaves: List[Any], is_leaf: IsLeaf = None) -> Any:
    """``like``'s structure holding ``leaves`` (in `flatten`'s order)."""
    it = iter(leaves)
    out = _rebuild(like, it, is_leaf)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any,
             is_leaf: IsLeaf = None) -> Any:
    """``fn`` over every leaf, in `flatten`'s order, keeping the
    structure."""
    return unflatten(tree, [fn(x) for x in flatten(tree, is_leaf)], is_leaf)


def treedef_str(tree: Any, is_leaf: IsLeaf = None) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` prints
    it for dicts, lists, tuples and leaves (``*``)."""
    def walk(x):
        if is_leaf is not None and is_leaf(x):
            return "*"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            return (f"CustomNode(namedtuple[{type(x).__name__}], ["
                    + ", ".join(walk(v) for v in x) + "])")
        if isinstance(x, list):
            return "[" + ", ".join(walk(v) for v in x) + "]"
        if isinstance(x, tuple):
            inner = ", ".join(walk(v) for v in x)
            return "(" + inner + ("," if len(x) == 1 else "") + ")"
        if x is None:
            return "None"
        return "*"
    return f"PyTreeDef({walk(tree)})"
