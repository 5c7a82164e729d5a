"""Graph-side codec stages: the lossy half of the client->server pipeline.

Port of ``repro.comms.stages``: delta extraction, error feedback (Eq. 5),
sparsification and uniform quantization.  ``UpstreamStages.compress``
returns ``(levels, recon, sparse)``, the boundary to the wire codecs.

``UpstreamStages.compress_carry`` is the fused route of the same chain
with error feedback on: where one threshold per leaf sparsifies
(``UpstreamStages.fused``), every leaf's carry, quantization and new
residual come from one ``level_assign_leaves`` kernel launch (each leaf
with its own threshold), bitwise equal to ``carry_residual -> compress ->
new_residual``.  ``compress_carry_cohort`` does the same for a cohort of
clients (the batched client round) in one launch.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import delta as delta_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import sparsify as sparsify_lib
from repro_torch.kernels.level_assign import level_assign_leaves
from repro_torch.tree import items, map_with_path, rebuild, tree_map


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

    @property
    def fused(self) -> bool:
        """Whether :meth:`compress_carry` applies: sparse, quantized, one
        threshold per leaf (fixed-rate top-k or Eq. 2, not structured)."""
        return (self.method == "sparse" and self.quantize
                and sparsify_lib.one_threshold(self.sparsify))

    def compress_carry(self, raw_delta: Any, residual: Any, fine_mask: Any):
        """Error feedback + :meth:`compress` + the new residual, fused.

        Per leaf: theta from ``|raw + residual|`` (the kernel forms the same
        float32 sum); then one ``level_assign_leaves`` call for every leaf's
        levels and new residual, one kernel launch on the card.  Returns
        ``(levels, recon, new_residual, update_sparsity)``; the sparsity is
        the zero share of the sparsified tensor (a kept element may still
        round to level 0).  One client's trees: :meth:`compress_carry_cohort`
        over a cohort of one.
        """
        def one(tree):
            return tree_map(lambda x: x[None], tree)

        def first(tree):
            return tree_map(lambda x: x[0], tree)

        levels, recon, carry, sparsity = self.compress_carry_cohort(
            one(raw_delta), one(residual), fine_mask)
        return first(levels), first(recon), first(carry), sparsity[0]

    def compress_carry_cohort(self, raw_delta: Any, residual: Any,
                              fine_mask: Any):
        """:meth:`compress_carry` over a cohort: every leaf of
        ``raw_delta`` and ``residual`` leads with the K clients, each client
        and leaf with its own theta (one ``topk`` a leaf for all its rows,
        a selection, so each row's own value), and one
        ``level_assign_leaves`` call takes them all (one kernel launch on
        the card for the cohort); the sparsity is (K,)."""
        if not self.fused:
            raise ValueError("compress_carry needs a fused stage chain")
        res = dict(items(residual))
        fine = dict(items(fine_mask))
        paths, deltas, residuals, thetas, steps = [], [], [], [], []
        zeros, total = 0, 0
        for path, d in items(raw_delta):
            carried = d + res[path]
            theta = sparsify_lib.leaf_threshold(carried, self.sparsify,
                                                cohort=True)
            flat = carried.reshape(carried.shape[0], -1)
            paths.append(path)
            deltas.append(d)
            residuals.append(res[path])
            thetas.append(theta)
            steps.append(self.quant.step_for(fine[path]))
            zeros = zeros + (flat.shape[1] - torch.count_nonzero(
                (torch.abs(flat) >= theta[:, None]) & (flat != 0), dim=1))
            total += flat.shape[1]
        levels, carries = level_assign_leaves(
            deltas, residuals, torch.stack(thetas, dim=1), steps,
            max_level=self.quant.max_level)
        lv_by = dict(zip(paths, levels))
        carry_by = dict(zip(paths, carries))
        recon_by = {path: lv.to(torch.float32) * quant_lib.f32(step, lv)
                    for path, lv, step in zip(paths, levels, steps)}
        sparsity = zeros.to(torch.float32) / total
        return (rebuild(raw_delta, lv_by), rebuild(raw_delta, recon_by),
                rebuild(raw_delta, carry_by), sparsity)


def quantize_scales_delta(s_delta: Any, fine_step_size: float):
    """Fine uniform quantization of the S update -> (levels, recon)."""
    levels = tree_map(lambda d: quant_lib.quantize(d, fine_step_size), s_delta)
    recon = tree_map(lambda q: quant_lib.dequantize(q, fine_step_size), levels)
    return levels, recon
