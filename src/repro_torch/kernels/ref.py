"""Plain PyTorch oracles for the port's kernels, as ``repro.kernels.ref``
holds the reference's.  Each is the plain version that sits beside its
kernel; only the kernels of the ported slice are here."""
from __future__ import annotations

import torch

from repro_torch.kernels.delta_compress import (delta_compress_batch_plain,
                                                delta_compress_plain)


def delta_compress(delta: torch.Tensor, theta: float, block: int):
    """(n,) -> (q int8 (n,), scales (ceil(n/block),))."""
    return delta_compress_plain(delta, theta, block)


def delta_compress_batch(deltas: torch.Tensor, theta: float, block: int):
    """Row-stacked oracle: row i == delta_compress(deltas[i], theta, block)."""
    return delta_compress_batch_plain(deltas, theta, block)
