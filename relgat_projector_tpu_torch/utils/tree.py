"""Minimal pytree helpers for nested dicts and lists of tensors.

Parameters keep the JAX package's pytree layout; leaves are ordered as
``jax.tree_util.tree_leaves`` orders them (dict keys sorted, lists in order),
so leaf lists of the two packages line up.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure, visiting
    leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {
            k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)
        }
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    return fn(tree, *rest)
