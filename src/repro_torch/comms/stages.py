"""Graph-side codec stages: the lossy half of the client->server pipeline.

Port of ``repro.comms.stages``: delta extraction, error feedback (Eq. 5),
sparsification and uniform quantization.  ``UpstreamStages.compress``
returns ``(levels, recon, sparse)``, the boundary to the wire codecs.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import delta as delta_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import sparsify as sparsify_lib
from repro_torch.tree import map_with_path, tree_map


def path_fine_mask(params: Any) -> Any:
    """Fine-quantized leaves: biases / norm params (1-D) per paper §5.1."""
    return map_with_path(lambda path, leaf: ("bn" in path) or leaf.ndim < 2,
                         params)


def extract_delta(params_after: Any, params_before: Any) -> Any:
    """Stage 1: differential update dW = W_after - W_before."""
    return delta_lib.tree_sub(params_after, params_before)


def carry_residual(raw_delta: Any, residual: Any, enabled: bool) -> Any:
    """Stage 2: error feedback (Eq. 5), re-inject last round's residual."""
    return delta_lib.tree_add(raw_delta, residual) if enabled else raw_delta


def new_residual(carried: Any, recon: Any, enabled: bool,
                 prev_residual: Any) -> Any:
    """Residual for the next round: what the lossy stages discarded."""
    return delta_lib.tree_sub(carried, recon) if enabled else prev_residual


@dataclasses.dataclass(frozen=True)
class UpstreamStages:
    """Lossy stage chain for the upstream direction.

    ``method``: "none" (identity), "sparse" (Eqs. 2/3 or fixed-rate top-k)
    or "ternary" (STC).  ``compress`` returns int32 ``levels`` (the level
    codecs' input), ``recon`` (what the server applies) and ``sparse``
    (the post-sparsification tensor, for metrics).
    """
    method: str = "sparse"
    quantize: bool = True
    sparsify: sparsify_lib.SparsifyConfig = dataclasses.field(
        default_factory=sparsify_lib.SparsifyConfig)
    quant: quant_lib.QuantConfig = dataclasses.field(
        default_factory=quant_lib.QuantConfig)
    ternary_sparsity: float = 0.96

    def compress(self, carried: Any, fine_mask: Any):
        if self.method == "none":
            recon = carried
            levels = quant_lib.quantize_tree(carried, self.quant, fine_mask)
            sparse = carried
        elif self.method == "ternary":
            recon = delta_lib.ternary_compress(carried, self.ternary_sparsity)
            levels = tree_map(lambda r: torch.sign(r).to(torch.int32), recon)
            sparse = recon
        elif self.method == "sparse":
            sparse = sparsify_lib.sparsify_tree(carried, self.sparsify)
            levels = quant_lib.quantize_tree(sparse, self.quant, fine_mask)
            recon = (quant_lib.dequantize_tree(levels, self.quant, fine_mask)
                     if self.quantize else sparse)
        else:
            raise ValueError(f"unknown compression method: {self.method!r}")
        return levels, recon, sparse


def quantize_scales_delta(s_delta: Any, fine_step_size: float):
    """Fine uniform quantization of the S update -> (levels, recon)."""
    levels = tree_map(lambda d: quant_lib.quantize(d, fine_step_size), s_delta)
    recon = tree_map(lambda q: quant_lib.dequantize(q, fine_step_size), levels)
    return levels, recon
