"""Trees of tensors: nested dicts, lists and tuples whose leaves are tensors
(or other values), the port's counterpart of JAX pytrees for the training
path.  Dicts keep their insertion order (JAX sorts dict keys; nothing here
depends on the order)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in traversal order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf}, each path the keys (or list indices) joined by "/", as
    the JAX package's checkpoints name their leaves."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_like(target, flat: Dict[str, Any], prefix: str = ""):
    """The tree of ``target``'s structure whose leaves are ``flat``'s values
    under the same paths."""
    if isinstance(target, dict):
        return {k: unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(unflatten_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
                            for i, v in enumerate(target))
    return flat[prefix]
