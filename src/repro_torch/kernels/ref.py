"""Plain PyTorch oracles for the port's kernels, as ``repro.kernels.ref``
holds the reference's.  Each is the plain version that sits beside its
kernel; only the kernels of the ported slice are here."""
from __future__ import annotations

import torch

from repro_torch.kernels.delta_apply import delta_apply_plain
from repro_torch.kernels.delta_compress import (delta_compress_batch_plain,
                                                delta_compress_plain)
from repro_torch.kernels.level_assign import MAX_LEVEL, level_assign_plain
from repro_torch.kernels.row_stats import row_stats_plain
from repro_torch.kernels.scaled_matmul import scaled_matmul_plain


def scaled_matmul(x: torch.Tensor, w: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """y = x @ (s * W)^T -- Eq. 4 applied at matmul time; x (M, K), w (N, K)
    output-rows-first, s (N,), float32 accumulate."""
    return scaled_matmul_plain(x, w, s)


def delta_compress(delta: torch.Tensor, theta: float, block: int):
    """(n,) -> (q int8 (n,), scales (ceil(n/block),))."""
    return delta_compress_plain(delta, theta, block)


def delta_compress_batch(deltas: torch.Tensor, theta: float, block: int):
    """Row-stacked oracle: row i == delta_compress(deltas[i], theta, block)."""
    return delta_compress_batch_plain(deltas, theta, block)


def level_assign(deltas: torch.Tensor, residuals: torch.Tensor, theta,
                 step, max_level: int = MAX_LEVEL):
    """Fused EF carry (Eq. 5) -> threshold sparsify -> uniform quantize on
    (K, n) rows -> (levels int32, carry float32)."""
    return level_assign_plain(deltas, residuals, theta, step, max_level)


def delta_apply(w: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                block: int, mean_coef: float = 1.0) -> torch.Tensor:
    """Fused dequant + apply: w + coef * (q * scale) (server-side update)."""
    return delta_apply_plain(w, q, scales, mean_coef, block)


def row_stats(w: torch.Tensor) -> torch.Tensor:
    """Per-output-row mean |w|: the Eq. 3 structured-sparsity score."""
    return row_stats_plain(w)
