"""Public wrappers for the port's kernels, as ``repro.kernels.ops``: the
reference's default block sizes and shape handling.  Each call launches
the CUDA kernel on a CUDA tensor and takes the plain version on a CPU
tensor."""
from __future__ import annotations

from repro_torch.kernels import delta_apply as da
from repro_torch.kernels import delta_compress as dc
from repro_torch.kernels import level_assign as la
from repro_torch.kernels import row_stats as rs
from repro_torch.kernels import scaled_matmul as sm


def scaled_matmul(x, w, s):
    """y = x @ (s * W)^T for any (M, K), (N, K), (N,): no padding to block
    multiples (the reference pads to 128); differentiable."""
    return sm.scaled_matmul(x, w, s)


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


def delta_apply(w, q, scales, coef=1.0, *, block=1024):
    """Flat (n,) w and q, ``ceil(n/block)`` scales: ``w + coef * q * s``."""
    return da.delta_apply(w, q, scales, coef, block=block)


def row_stats(w):
    """(M, N) -> (M,) mean |w| per row: the true row sum over N, with no
    padding to block sizes (the reference pads and rescales)."""
    return rs.row_stats(w)
