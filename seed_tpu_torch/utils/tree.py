"""Trees of tensors: nested dicts and lists, as every model of the package
keeps its parameters (the counterpart of the jax.tree calls seed_tpu makes).

A leaf is anything that is not a dict, list or tuple. ``None`` marks an
absent leaf (the complement of ``split_trainable`` or ``filter_tree``, a
frozen leaf under ``masked_trainable``): the map functions hand it back
untouched and ``leaves`` leaves it out.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple


def path_str(path: Sequence[Any]) -> str:
    """Tree path -> 'a/b/0/c' (seed_tpu/parallel/partition.py:path_str)."""
    return "/".join(str(p) for p in path)


def map_with_path(fn: Callable, tree: Any, *rest: Any, _path: Tuple = ()) -> Any:
    """``fn(path, leaf, *other_leaves)`` over every leaf of ``tree`` that is
    not None; ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), _path=_path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, *(r[i] for r in rest), _path=_path + (i,))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(_path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *other_leaves)`` over every leaf of ``tree`` that is not
    None."""
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def leaves_with_path(tree: Any) -> List[Tuple[str, Any]]:
    """[(path string, leaf)] of every leaf that is not None, in tree order."""
    out: List[Tuple[str, Any]] = []
    map_with_path(lambda p, leaf: out.append((path_str(p), leaf)), tree)
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]
