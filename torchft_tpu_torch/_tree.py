"""Pytree flatten/unflatten in ``jax.tree_util`` order.

Dict keys are visited sorted, lists and tuples in order, ``None`` is an
empty subtree, and anything else is a leaf. The order is the contract
that lets a JAX replica group and a torch replica group share one comm
plan: both packages flatten the same parameter tree into the same leaf
order, so plan group layouts match leaf for leaf. (``torch.utils._pytree``
keeps dict insertion order, which is why the port has its own.)

The treedef is a nested tuple: hashable, so it can key a plan cache.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

TreeDef = Any
# A leaf's path: the dict keys and sequence indices from the root to it.
Path = Tuple[Any, ...]


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def rec(t: Any) -> TreeDef:
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(rec(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, tuple(rec(x) for x in t))
        if t is None:
            return ("none",)
        leaves.append(t)
        return ("leaf",)

    treedef = rec(tree)
    return leaves, treedef


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[Path, Any]], TreeDef]:
    """:func:`flatten` with each leaf's path, in the same order and with
    the same treedef (a separate walk: :func:`flatten` runs on every
    step's gradients and builds no paths)."""
    leaves: List[Tuple[Path, Any]] = []

    def rec(t: Any, path: Path) -> TreeDef:
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys),
                    tuple(rec(t[k], path + (k,)) for k in keys))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__,
                    tuple(rec(x, path + (i,)) for i, x in enumerate(t)))
        if t is None:
            return ("none",)
        leaves.append((path, t))
        return ("leaf",)

    treedef = rec(tree, ())
    return leaves, treedef


def is_opt_state_path(path: Path) -> bool:
    """True when a leaf's path passes through a key named ``opt_state``:
    the only leaves the heal's bf16 wire may narrow. Protect by default:
    a leaf under any other name (weights, whatever the caller calls them)
    ships raw."""
    return any(isinstance(k, str) and k == "opt_state" for k in path)


def unflatten(treedef: TreeDef, leaves: Sequence[Any]) -> Any:
    it = iter(leaves)

    def rec(d: TreeDef) -> Any:
        kind = d[0]
        if kind == "dict":
            return {k: rec(sub) for k, sub in zip(d[1], d[2])}
        if kind == "list":
            return [rec(sub) for sub in d[1]]
        if kind == "tuple":
            return tuple(rec(sub) for sub in d[1])
        if kind == "none":
            return None
        return next(it)

    out = rec(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [fn(leaf) for leaf in leaves])
