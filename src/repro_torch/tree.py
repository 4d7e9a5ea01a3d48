"""Parameter trees of the port: nested dicts, lists and tuples of tensors
(or arrays), visited in the order JAX's tree utilities visit them: dict
keys sorted, sequences by index, ``None`` no leaf. The checkpoint
manager keys its files by these paths, and the optimizer and the
gradient compression sum and map over the leaves in this order, so a
global norm adds its terms as ``jax.tree.leaves`` lists them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

__all__ = ["items", "leaves", "tree_map", "unflatten"]


def items(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's visiting order; a path joins its keys
    and indices with ``/``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in items(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in items(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def leaves(tree) -> List[Any]:
    """The leaves in JAX's visiting order."""
    return [leaf for _, leaf in items(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), into a tree of ``tree``'s
    structure. Leaves are visited in JAX's order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def unflatten(like, values: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """A tree of ``like``'s structure whose leaves are ``values[path]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: unflatten(v, values, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [unflatten(v, values, prefix + (str(i),))
               for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    return values["/".join(prefix)]
