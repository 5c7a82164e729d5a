"""Per-row mean ``|w|`` (the Eq. 3 filter scores), the port of
``repro/kernels/row_stats.py``.

``row_stats`` launches the hand-written CUDA kernel of
``csrc/row_stats.cu`` on a CUDA tensor and uses the plain PyTorch version
beside it on a CPU tensor; any other device raises.  It takes any
``(M, N)`` shape and divides the true row sum by ``N``: the reference's
padding to its TPU block sizes is not needed.  The kernel sums in another
order than ``torch.mean``, so the two agree to rtol 1e-6, not bitwise.

On the port's path ``core.sparsify.row_scores`` calls it once per leaf of
two or more dimensions, on the ``(M, -1)`` view, wherever the structured
stage runs (Eq. 3 thresholds and fixed-rate ``topk_rows``).

``LAUNCHES`` counts kernel launches (only where the CUDA kernel is
launched); ``CALLS`` counts wrapper calls on any device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = {"row_stats": 0}
CALLS = {"row_stats": 0}


def reset_counters() -> None:
    for counts in (LAUNCHES, CALLS):
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------ plain version

def row_stats_plain(w: torch.Tensor) -> torch.Tensor:
    """Mean ``|w|`` over each row, in tensor ops on any device."""
    return torch.mean(torch.abs(w), dim=1)


# ------------------------------------------------------------ CUDA kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("row_stats")
    fn = lib.row_stats_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(w: torch.Tensor) -> torch.Tensor:
    m, n = w.shape
    dev = w.device
    if m == 0 or n == 0:   # nothing to read; the mean of no element is nan
        return torch.full((m,), float("nan"), device=dev)
    w = w.contiguous()
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().row_stats_launch(
            w.data_ptr(), out.data_ptr(), m, n,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"row_stats kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["row_stats"] += 1
    return out


def row_stats(w: torch.Tensor) -> torch.Tensor:
    """w (M, N) float32 -> (M,) float32 mean ``|w|`` per row."""
    if w.ndim != 2:
        raise ValueError(f"row_stats takes an (M, N) tensor, got shape "
                         f"{tuple(w.shape)}")
    if w.dtype != torch.float32:
        raise TypeError(f"row_stats takes float32, got {w.dtype}")
    CALLS["row_stats"] += 1
    if w.device.type == "cpu":
        return row_stats_plain(w)
    if w.device.type != "cuda":
        raise ValueError(f"row_stats runs on CUDA or CPU tensors, got "
                         f"{w.device}")
    return _launch(w)
