"""Error accumulation / error feedback (paper §5.5, Eq. 5).

Port of ``repro.core.residual``: the residual is what compression discarded,
``residual = (raw + residual) - compressed``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import tree_map


def zeros_like_tree(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def apply_error_feedback(raw_delta: Any, residual: Any,
                         compress_fn: Callable[[Any], Any]):
    """-> (compress_fn(raw + residual), (raw + residual) - compressed)."""
    carried = tree_map(lambda d, r: d + r, raw_delta, residual)
    compressed = compress_fn(carried)
    new_residual = tree_map(lambda c, q: c - q, carried, compressed)
    return compressed, new_residual
