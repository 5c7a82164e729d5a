"""Public wrappers for the port's kernels, as ``repro.kernels.ops``: the
reference's default block sizes and shape handling.  Each call launches
the CUDA kernel on a CUDA tensor and takes the plain version on a CPU
tensor."""
from __future__ import annotations

from repro_torch.kernels import delta_compress as dc
from repro_torch.kernels import level_assign as la


def delta_compress(delta, theta, *, block=1024):
    """Any-shape delta, flattened; q comes back in the input's shape."""
    q, scales = dc.delta_compress(delta.reshape(-1), theta, block=block)
    return q.reshape(delta.shape), scales


def delta_compress_flat(delta, theta, *, block=1024):
    """Flat (n,) variant."""
    return dc.delta_compress(delta, theta, block=block)


def delta_compress_batch(deltas, theta, *, block=128):
    """Cohort (K, n) variant: one launch, rows equal to per-client calls."""
    return dc.delta_compress_batch(deltas, theta, block=block)


def level_assign(deltas, residuals, theta, step, *, max_level=la.MAX_LEVEL):
    """Stacked (K, n) rows sharing one theta and step: one launch."""
    return la.level_assign(deltas, residuals, theta, step,
                           max_level=max_level)
