"""Filter / output-neuron scaling factors (paper §4, Eq. 4).

Port of ``repro.core.scaling``.  Every eligible weight W (conv (M,N,K,K),
dense (M,N)) gets a per-output scale S in R^M, initialised to 1 and applied
as ``W*_m = W_m * s_m``.  Leaves of unscaled params hold a scalar 1.0
placeholder so the scales tree mirrors the params tree; the placeholders
are part of the wire format (the float codecs' scales section carries
them).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import leaves, map_with_path, tree_map

ScalePredicate = Callable[[str, torch.Tensor], bool]


def default_predicate(path: str, leaf: torch.Tensor) -> bool:
    del path
    return leaf.ndim >= 2


def path_str(key_path) -> str:
    """``/``-joined keys of a key path: dict keys and tuple indices as
    they are, or the ``key``/``idx`` of key-path entries (the paths
    ``tree.items`` yields)."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in key_path)


def init_scales(params: Any,
                predicate: ScalePredicate = default_predicate) -> Any:
    """Ones-initialised scales tree (paper: S <- 1)."""

    def leaf_init(path, leaf):
        shape = (leaf.shape[0],) if predicate(path, leaf) else ()
        return torch.ones(shape, dtype=torch.float32, device=leaf.device)

    return map_with_path(leaf_init, params)


def scale_mask(params: Any,
               predicate: ScalePredicate = default_predicate) -> Any:
    """Tree of Python bools marking leaves that carry real scales."""
    return map_with_path(lambda path, leaf: predicate(path, leaf), params)


def num_scale_params(scales: Any, mask: Any) -> int:
    """Paper Table 1 ``#params_add``: the scale elements of the leaves that
    carry real scales."""
    return sum(s.numel() for s, m in zip(leaves(scales), leaves(mask)) if m)


def apply_scale(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """W*_m = W_m * s_m; a scalar placeholder broadcasts trivially.  A
    cohort's leaves lead with K: scales (K, O) scale w (K, O, ...) per
    client and row, placeholders (K,) per client."""
    if s.ndim == 0:
        return w * s
    return w * s.reshape(tuple(s.shape) + (1,) * (w.ndim - s.ndim)).to(
        w.dtype)


def at_matmul(w: torch.Tensor, s: torch.Tensor, cohort: bool = False) -> bool:
    """A dense weight (N, K) with a per-row scale (N,) (a cohort's: (K, N,
    C) with (K, N)): the models' dense apply takes the scale inside its
    product (``kernels.scaled_matmul``)."""
    return w.ndim == 2 + cohort and s.ndim == 1 + cohort


def apply_scales_tree(params: Any, scales: Any, cohort: bool = False) -> Any:
    """Every leaf times its scale, except the dense leaves that
    ``at_matmul`` names: the model's dense apply takes those scales inside
    its product, so they stay unscaled here.  ``cohort``: every leaf leads
    with the cohort axis."""
    return tree_map(lambda w, s: w if at_matmul(w, s, cohort)
                    else apply_scale(w, s), params, scales)


def bake_scales(params: Any, scales: Any) -> tuple[Any, Any]:
    """Fold every scale into its weight and reset the scales to 1 (a
    server-side option) -> ``(baked params, ones)``."""
    baked = tree_map(apply_scale, params, scales)
    return baked, tree_map(torch.ones_like, scales)


def masked_update(scales: Any, updates: Any, mask: Any) -> Any:
    """Apply updates only where the mask marks a real scale leaf."""
    return tree_map(lambda s, u, m: s + u if m else s, scales, updates, mask)
