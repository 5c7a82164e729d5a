"""Differential-update compression (paper §3): sparsify, then quantize.

Port of ``repro.core.delta``: ``compress_delta`` is the dense-out lossy
round trip the server sees, ``delta_levels`` its integer levels (the
codec's input), ``ternary_compress`` the STC baseline.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import quant as quant_lib
from repro_torch.core import sparsify as sparsify_lib
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    sparsify: sparsify_lib.SparsifyConfig = dataclasses.field(
        default_factory=sparsify_lib.SparsifyConfig)
    quant: quant_lib.QuantConfig = dataclasses.field(
        default_factory=quant_lib.QuantConfig)
    enabled: bool = True  # False -> identity (raw FedAvg baseline)

    def replace(self, **kw) -> "CompressionConfig":
        return dataclasses.replace(self, **kw)


def tree_sub(a: Any, b: Any) -> Any:
    return tree_map(lambda x, y: x - y, a, b)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(lambda x, y: x + y, a, b)


def compress_delta(delta: Any, cfg: CompressionConfig,
                   fine_mask: Any | None = None) -> Any:
    """Sparsify, quantize, dequantize: the reconstruction the entropy
    coder carries losslessly, so ``delta - compress_delta(delta)`` is the
    residual (Eq. 5)."""
    if not cfg.enabled:
        return delta
    sparse = sparsify_lib.sparsify_tree(delta, cfg.sparsify)
    levels = quant_lib.quantize_tree(sparse, cfg.quant, fine_mask)
    return quant_lib.dequantize_tree(levels, cfg.quant, fine_mask)


def delta_levels(delta: Any, cfg: CompressionConfig,
                 fine_mask: Any | None = None) -> Any:
    """Integer quantization levels of the compressed delta (codec input)."""
    sparse = (sparsify_lib.sparsify_tree(delta, cfg.sparsify) if cfg.enabled
              else delta)
    return quant_lib.quantize_tree(sparse, cfg.quant, fine_mask)


def ternary_compress(delta: Any, sparsity: float) -> Any:
    """Sparse Ternary Compression (STC): survivors of a magnitude top-k
    become ``mu * sign(dw)``, ``mu`` the survivors' mean magnitude."""

    def one(dw: torch.Tensor) -> torch.Tensor:
        mask = sparsify_lib.topk_mask_unstructured(dw, sparsity)
        kept = torch.where(mask, dw, 0.0)
        denom = torch.clamp(torch.sum(mask), min=1)
        mu = torch.sum(torch.abs(kept)) / denom
        return torch.where(mask, mu * torch.sign(dw), 0.0)

    return tree_map(one, delta)
