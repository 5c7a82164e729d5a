"""Differential-update tree arithmetic and STC ternary compression.

Port of ``repro.core.delta`` as far as the stage chain uses it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import sparsify as sparsify_lib
from repro_torch.tree import tree_map


def tree_sub(a: Any, b: Any) -> Any:
    return tree_map(lambda x, y: x - y, a, b)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(lambda x, y: x + y, a, b)


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
