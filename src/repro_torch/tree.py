"""Parameter trees: nested dicts and NamedTuples with tensor leaves.

The port's stand-in for JAX pytrees.  A path is the ``/``-joined chain of
dict keys (and tuple indices), exactly ``repro.core.scaling.path_str`` on
the reference's dict trees, so ``sorted_items`` yields the codecs' wire
order.  ``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Shape of one logical tensor in a shapes tree (a leaf, not a tuple,
    so tree walks stop at it)."""
    shape: tuple


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def items(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in insertion order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        pairs = tree.items()
    elif isinstance(tree, (tuple, list)):
        pairs = enumerate(tree)
    else:
        return [(prefix, tree)]
    out: list[tuple[str, Any]] = []
    for k, v in pairs:
        out.extend(items(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def sorted_items(tree: Any) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in sorted-path order: THE wire order."""
    return sorted(items(tree), key=lambda kv: kv[0])


def leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in items(tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                  prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a tree, paths as in :func:`items`."""
    def sub(k, v):
        return map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: sub(k, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(sub(i, v) for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(sub(i, v) for i, v in enumerate(tree))
    return fn(prefix, tree)


def rebuild(template: Any, by_path: dict[str, Any]) -> Any:
    """``template``'s structure with the leaf at each path from ``by_path``."""
    return map_with_path(lambda path, _: by_path[path], template)


def row(tree: Any, i) -> Any:
    """Index the leading (client) axis of every leaf."""
    return tree_map(lambda x: x[i], tree)


def stack(trees: list[Any]) -> Any:
    """Trees of one structure stacked leafwise on a new leading axis."""
    import torch
    return tree_map(lambda *leaves_: torch.stack(leaves_), *trees)


def per_row(t: Any, leaf: Any) -> Any:
    """A per-row (K,) tensor shaped to broadcast over ``leaf``'s leading
    axis; a 0-d one as it is."""
    if t.ndim == 0:
        return t
    return t.reshape(tuple(t.shape) + (1,) * (leaf.ndim - t.ndim))
