"""Fused error-feedback carry + threshold sparsify + uniform quantization,
the port of ``repro/kernels/level_assign.py``.

    carried = deltas + residuals                    # Eq. 5
    kept    = where(|carried| >= theta, carried, 0)
    levels  = clip(round(kept / step), ±max_level)  # int32, half to even
    carry   = carried - levels * step               # next residual

``level_assign`` launches the hand-written CUDA kernel of
``csrc/level_assign.cu`` on CUDA tensors and uses the plain PyTorch
version beside it on CPU tensors; any other device raises.  ``theta`` and
``step`` are float32 scalars shared by the rows; on the card the kernel
reads them from device memory, so a threshold computed there (a top-k
value) is passed without a host sync.

On the client's main path it runs once per leaf (K = 1): each client and
each leaf has its own top-k threshold.

``LAUNCHES`` counts kernel launches (only where the CUDA kernel is
launched); ``CALLS`` counts wrapper calls on any device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_LEVEL = 2**23
LAUNCHES = {"level_assign": 0}
CALLS = {"level_assign": 0}


def reset_counters() -> None:
    for counts in (LAUNCHES, CALLS):
        for k in counts:
            counts[k] = 0


def _scalar(x, device: torch.device) -> torch.Tensor:
    """``x`` (a float or a one-element tensor) as a float32 (1,) tensor on
    ``device``."""
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    if t.numel() != 1:
        raise ValueError(f"theta and step are scalars, got shape "
                         f"{tuple(t.shape)}")
    return t.reshape(1)


def _empty(k: int, n: int, dev: torch.device):
    return (torch.zeros((k, n), dtype=torch.int32, device=dev),
            torch.zeros((k, n), dtype=torch.float32, device=dev))


# ------------------------------------------------------------ plain version

def level_assign_plain(deltas: torch.Tensor, residuals: torch.Tensor,
                       theta, step, max_level: int = MAX_LEVEL):
    """The kernel's arithmetic in tensor ops, on any device: the division
    is tensor by tensor (a CUDA tensor divided by a Python float becomes a
    multiply by the rounded reciprocal), ``torch.round`` is half to even,
    the clip precedes the int32 cast, and the carry subtracts the clipped
    float level times the step, as the reference does."""
    k, n = deltas.shape
    dev = deltas.device
    if k == 0 or n == 0:
        return _empty(k, n, dev)
    th, st = _scalar(theta, dev), _scalar(step, dev)
    carried = deltas + residuals
    kept = torch.where(torch.abs(carried) >= th, carried, 0.0)
    lv = torch.clamp(torch.round(kept / st), -max_level, max_level)
    return lv.to(torch.int32), carried - lv * st


# ------------------------------------------------------------ CUDA kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("level_assign")
    fn = lib.level_assign_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(deltas: torch.Tensor, residuals: torch.Tensor, theta, step,
            max_level: int):
    k, n = deltas.shape
    dev = deltas.device
    if k == 0 or n == 0:
        return _empty(k, n, dev)
    if k > 65535:
        raise ValueError(f"at most 65535 rows per launch, got {k}")
    d, r = deltas.contiguous(), residuals.contiguous()
    th, st = _scalar(theta, dev), _scalar(step, dev)
    levels = torch.empty((k, n), dtype=torch.int32, device=dev)
    carry = torch.empty((k, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().level_assign_launch(
            d.data_ptr(), r.data_ptr(), th.data_ptr(), st.data_ptr(),
            levels.data_ptr(), carry.data_ptr(), k, n, float(max_level),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"level_assign kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["level_assign"] += 1
    return levels, carry


def level_assign(deltas: torch.Tensor, residuals: torch.Tensor, theta, step,
                 *, max_level: int = MAX_LEVEL):
    """deltas, residuals (K, n) float32 -> (levels int32 (K, n), carry
    float32 (K, n)); ``theta``/``step`` are floats or one-element tensors."""
    if deltas.ndim != 2 or residuals.shape != deltas.shape:
        raise ValueError(f"level_assign takes two (K, n) tensors of one "
                         f"shape, got {tuple(deltas.shape)} and "
                         f"{tuple(residuals.shape)}")
    if deltas.dtype != torch.float32 or residuals.dtype != torch.float32:
        raise TypeError(f"level_assign takes float32 tensors, got "
                        f"{deltas.dtype} and {residuals.dtype}")
    if residuals.device != deltas.device:
        raise ValueError(f"deltas on {deltas.device}, residuals on "
                         f"{residuals.device}")
    if not 0 < max_level <= 2**24:
        raise ValueError(f"max_level must be in (0, 2**24], got {max_level}")
    CALLS["level_assign"] += 1
    if deltas.device.type == "cpu":
        return level_assign_plain(deltas, residuals, theta, step, max_level)
    if deltas.device.type != "cuda":
        raise ValueError(f"level_assign runs on CUDA or CPU tensors, got "
                         f"{deltas.device}")
    return _launch(deltas, residuals, theta, step, max_level)
