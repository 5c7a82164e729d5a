"""Fused threshold-sparsify + per-block int8 quantization (paper §3 wire
format), the port of ``repro/kernels/delta_compress.py``.

``delta_compress`` (one client, (n,)) and ``delta_compress_batch`` (a
cohort, (K, n)) launch the hand-written CUDA kernel of
``csrc/delta_compress.cu`` on a CUDA tensor and use the plain PyTorch
version beside it on a CPU tensor; any other device raises.  Ragged ``n``
is zero-padded on the device to a block multiple (a zero never wins the
block maximum and quantizes to 0, and an all-pad block gets the scale-1
sentinel), and the results are sliced back.  Row i of the batch result is
bit-equal to ``delta_compress(deltas[i])``.

``LAUNCHES`` counts kernel launches per wrapper (only where the CUDA kernel
is launched); ``CALLS`` counts wrapper calls on any device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

LAUNCHES = {"delta_compress": 0, "delta_compress_batch": 0}
CALLS = {"delta_compress": 0, "delta_compress_batch": 0}


def reset_counters() -> None:
    for counts in (LAUNCHES, CALLS):
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------ plain version

def delta_compress_batch_plain(deltas: torch.Tensor, theta: float,
                               block: int):
    """The kernel's arithmetic in tensor ops, on any device.

    Both divisions are tensor-by-tensor (a CUDA tensor divided by a Python
    float becomes a multiply by the rounded reciprocal), ``torch.round`` is
    half to even, and the clip precedes the int8 cast."""
    k, n = deltas.shape
    dev = deltas.device
    if k == 0 or n == 0:
        return (torch.zeros((k, 0), dtype=torch.int8, device=dev),
                torch.zeros((k, 0), dtype=torch.float32, device=dev))
    pad = (-n) % block
    d = F.pad(deltas.to(torch.float32), (0, pad)).reshape(k, -1, block)
    th = torch.tensor(theta, dtype=torch.float32, device=dev)
    kept = torch.where(torch.abs(d) >= th, d, 0.0)
    amax = torch.amax(torch.abs(kept), dim=-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), 1.0)
    q = torch.clamp(torch.round(kept / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(k, -1)[:, :n], scale


def delta_compress_plain(delta: torch.Tensor, theta: float, block: int):
    q, s = delta_compress_batch_plain(delta.reshape(1, -1), theta, block)
    return q[0], s[0]


# ------------------------------------------------------------ CUDA kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("delta_compress")
    fn = lib.delta_compress_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_block(block: int) -> None:
    if block % 128 or not 128 <= block <= 1024:
        raise ValueError(f"block must be a multiple of 128 in [128, 1024], "
                         f"got {block}")


def _launch(deltas: torch.Tensor, theta: float, block: int, name: str):
    """(K, n) float32 CUDA tensor -> (q (K, n) int8, scales (K, nblk));
    counts the launch under ``name``."""
    k, n = deltas.shape
    dev = deltas.device
    if k == 0 or n == 0:
        return (torch.zeros((k, 0), dtype=torch.int8, device=dev),
                torch.zeros((k, 0), dtype=torch.float32, device=dev))
    if k > 65535:
        raise ValueError(f"at most 65535 rows per launch, got {k}")
    pad = (-n) % block
    d = deltas.contiguous()
    if pad:
        d = F.pad(d, (0, pad))
    elif d.data_ptr() % 16:
        d = d.clone()  # the kernel loads float4s
    p = n + pad
    q = torch.empty((k, p), dtype=torch.int8, device=dev)
    scales = torch.empty((k, p // block), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().delta_compress_launch(
            d.data_ptr(), q.data_ptr(), scales.data_ptr(), k, p, block,
            float(theta), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"delta_compress kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
    return (q[:, :n] if pad else q), scales


def _dispatch(deltas: torch.Tensor, theta: float, block: int, name: str):
    if deltas.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 deltas, got {deltas.dtype}")
    _check_block(block)
    CALLS[name] += 1
    if deltas.device.type == "cpu":
        return delta_compress_batch_plain(deltas, theta, block)
    if deltas.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{deltas.device}")
    return _launch(deltas, theta, block, name)


def delta_compress(delta: torch.Tensor, theta: float, *, block: int = 1024):
    """delta (n,) float32 -> (q int8 (n,), scales float32 (ceil(n/block),))."""
    if delta.ndim != 1:
        raise ValueError(f"delta_compress takes a 1-D delta, got shape "
                         f"{tuple(delta.shape)}")
    q, s = _dispatch(delta.reshape(1, -1), theta, block, "delta_compress")
    return q[0], s[0]


def delta_compress_batch(deltas: torch.Tensor, theta: float, *,
                         block: int = 128):
    """deltas (K, n) float32 -> (q int8 (K, n), scales (K, ceil(n/block)))
    in one launch; row i equals ``delta_compress(deltas[i])``."""
    if deltas.ndim != 2:
        raise ValueError(f"delta_compress_batch takes (K, n) deltas, got "
                         f"shape {tuple(deltas.shape)}")
    return _dispatch(deltas, theta, block, "delta_compress_batch")
