"""Fused dequantize + apply of an int8-blockscale update, the port of
``repro/kernels/delta_compress.py::delta_apply``:

    out = w + coef * (q * scales[i // block])

``delta_apply`` launches the hand-written CUDA kernel of
``csrc/delta_apply.cu`` on CUDA tensors and uses the plain PyTorch version
beside it on CPU tensors; any other device raises.  ``n`` may be ragged:
``scales`` has ``ceil(n / block)`` entries, the layout ``delta_compress``
emits and the ``int8-blockscale`` wire carries (its block is 128).

On the port's path the server applies the decoded int8 broadcast with
``coef = +1`` and the downlink forms its error-feedback residual with
``coef = -1``, one launch per leaf each.

``LAUNCHES`` counts kernel launches (only where the CUDA kernel is
launched); ``CALLS`` counts wrapper calls on any device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

LAUNCHES = {"delta_apply": 0}
CALLS = {"delta_apply": 0}


def reset_counters() -> None:
    for counts in (LAUNCHES, CALLS):
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------ plain version

def delta_apply_plain(w: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                      coef: float, block: int) -> torch.Tensor:
    """The kernel's arithmetic in tensor ops, on any device: ``q * scale``
    per block, times ``coef`` (a float32 tensor), added to ``w``; three
    separate rounded operations, as the reference's."""
    n = w.shape[0]
    if n == 0:
        return w.clone()
    pad = (-n) % block
    deq = (F.pad(q.to(torch.float32), (0, pad)).reshape(-1, block)
           * scales[:, None]).reshape(-1)[:n]
    c = torch.tensor(coef, dtype=torch.float32, device=w.device)
    return w + c * deq


# ------------------------------------------------------------ CUDA kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("delta_apply")
    fn = lib.delta_apply_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(w: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
            coef: float, block: int) -> torch.Tensor:
    n = w.shape[0]
    dev = w.device
    if n == 0:
        return w.clone()
    w, q, scales = w.contiguous(), q.contiguous(), scales.contiguous()
    out = torch.empty_like(w)
    with torch.cuda.device(dev):
        err = _lib().delta_apply_launch(
            w.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(), n,
            block, float(coef), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"delta_apply kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["delta_apply"] += 1
    return out


def delta_apply(w: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                coef: float = 1.0, *, block: int = 128) -> torch.Tensor:
    """w (n,) float32, q (n,) int8, scales (ceil(n/block),) float32 ->
    ``w + coef * q * scale`` (n,) float32."""
    if w.ndim != 1 or q.shape != w.shape:
        raise ValueError(f"delta_apply takes w and q of one (n,) shape, got "
                         f"{tuple(w.shape)} and {tuple(q.shape)}")
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    nblk = -(-w.shape[0] // block)
    if scales.shape != (nblk,):
        raise ValueError(f"scales must be ({nblk},) for n = {w.shape[0]} "
                         f"and block {block}, got {tuple(scales.shape)}")
    if (w.dtype != torch.float32 or q.dtype != torch.int8
            or scales.dtype != torch.float32):
        raise TypeError(f"delta_apply takes float32 w and scales and int8 q, "
                        f"got {w.dtype}, {q.dtype}, {scales.dtype}")
    if not w.device == q.device == scales.device:
        raise ValueError(f"w on {w.device}, q on {q.device}, scales on "
                         f"{scales.device}")
    CALLS["delta_apply"] += 1
    if w.device.type == "cpu":
        return delta_apply_plain(w, q, scales, coef, block)
    if w.device.type != "cuda":
        raise ValueError(f"delta_apply runs on CUDA or CPU tensors, got "
                         f"{w.device}")
    return _launch(w, q, scales, coef, block)
