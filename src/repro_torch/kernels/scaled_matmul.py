"""Matrix product with the per-output-row scaling factors of Eq. 4 applied
at matmul time, the port of ``repro/kernels/scaled_matmul.py``, with its
backward:

    y = x @ (s * W)^T          x (M, K), W (N, K), s (N,) -> (M, N)

``scaled_matmul`` is a ``torch.autograd.Function``.  Its forward and the
three products of its backward each launch a hand-written CUDA kernel of
``csrc/scaled_matmul.cu`` on CUDA tensors and take the plain PyTorch
version beside it on CPU tensors; any other device raises.  The backward
computes only the gradients asked for (``ctx.needs_input_grad``):

* weight steps (S frozen): ``dx = (dy * s) @ W`` and ``dW = s * dy^T x``;
* scale sub-epochs (W frozen): ``dx`` and ``ds[n] = sum_m dy[m, n]
  (x W^T)[m, n]``.

The plain versions repeat the float order of ``x @ apply_scale(W, s).T``
under autograd (``W * s`` first, then the product), so the port's CPU
path is that of the reference's oracle ``repro.kernels.ref.
scaled_matmul``.  The kernels scale the accumulator instead, as the TPU
kernel does, so the two agree to the float32 error bound of the sums, not
bitwise.

On the port's path every dense layer of the client round and of the
server's evaluation calls it (``models.cnn.dense_apply``).

``LAUNCHES`` counts kernel launches per direction (only where a CUDA
kernel is launched); ``CALLS`` counts wrapper calls on any device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DIRECTIONS = ("forward", "dx", "dw", "ds")
LAUNCHES = {d: 0 for d in DIRECTIONS}
CALLS = {d: 0 for d in DIRECTIONS}


def reset_counters() -> None:
    for counts in (LAUNCHES, CALLS):
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------ plain versions

def scaled_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """``x @ (s * W)^T``: the weight scaled first, as the reference's
    oracle."""
    return x @ (w * s[:, None]).T


def dx_plain(dy: torch.Tensor, w: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """d x of ``x @ (s * W)^T``: ``dy @ (s * W)``."""
    return dy @ (w * s[:, None])


def dw_plain(dy: torch.Tensor, x: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """d W: ``s * (dy^T @ x)``."""
    return (dy.T @ x) * s[:, None]


def ds_plain(dy: torch.Tensor, x: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """d s: the row sums of ``(dy^T @ x) * W``, which are ``sum_m dy[m, n]
    (x W^T)[m, n]``."""
    return torch.sum((dy.T @ x) * w, dim=1)


# ------------------------------------------------------------ CUDA kernels

def _lib() -> ctypes.CDLL:
    lib = build.load("scaled_matmul")
    for d in DIRECTIONS:
        fn = getattr(lib, f"scaled_matmul_{d}")
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _launch(direction: str, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, out_shape: tuple, m: int, n: int,
            k: int) -> torch.Tensor:
    dev = a.device
    if min(m, n, k) == 0:   # an empty sum: nothing to launch
        return torch.zeros(out_shape, dtype=torch.float32, device=dev)
    a, b, c = a.contiguous(), b.contiguous(), c.contiguous()
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(_lib(), f"scaled_matmul_{direction}")(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), m, n,
            k, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"scaled_matmul {direction} kernel launch "
                           f"failed: CUDA error {err}")
    LAUNCHES[direction] += 1
    return out


def _route(direction: str, device: torch.device) -> bool:
    """Counts the call; True for a CPU tensor (the plain version), False
    for a CUDA tensor (the kernel); raises on any other device."""
    CALLS[direction] += 1
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"scaled_matmul runs on CUDA or CPU tensors, got "
                         f"{device}")
    return False


def forward(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor):
    if _route("forward", x.device):
        return scaled_matmul_plain(x, w, s)
    m, k = x.shape
    return _launch("forward", x, w, s, (m, w.shape[0]), m, w.shape[0], k)


def dx(dy: torch.Tensor, w: torch.Tensor, s: torch.Tensor):
    if _route("dx", dy.device):
        return dx_plain(dy, w, s)
    m, n = dy.shape
    return _launch("dx", dy, w, s, (m, w.shape[1]), m, n, w.shape[1])


def dw(dy: torch.Tensor, x: torch.Tensor, s: torch.Tensor):
    if _route("dw", dy.device):
        return dw_plain(dy, x, s)
    m, n = dy.shape
    return _launch("dw", dy, x, s, (n, x.shape[1]), m, n, x.shape[1])


def ds(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor):
    if _route("ds", dy.device):
        return ds_plain(dy, x, w)
    m, n = dy.shape
    return _launch("ds", dy, x, w, (n,), m, n, x.shape[1])


# ------------------------------------------------------------ autograd

class ScaledMatmul(torch.autograd.Function):
    """``x @ (s * W)^T`` with a backward that computes only the gradients
    asked for."""

    @staticmethod
    def forward(ctx, x, w, s):
        ctx.save_for_backward(x, w, s)
        return forward(x, w, s)

    @staticmethod
    def backward(ctx, dy):
        x, w, s = ctx.saved_tensors
        need_x, need_w, need_s = ctx.needs_input_grad
        return (dx(dy, w, s) if need_x else None,
                dw(dy, x, s) if need_w else None,
                ds(dy, x, w) if need_s else None)


def scaled_matmul(x: torch.Tensor, w: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """x (M, K), w (N, K), s (N,) float32 on one device -> (M, N) float32
    ``x @ (s * W)^T``, differentiable in all three."""
    if x.ndim != 2 or w.ndim != 2 or s.shape != (w.shape[0],) or (
            x.shape[1] != w.shape[1]):
        raise ValueError(f"scaled_matmul takes x (M, K), w (N, K) and s "
                         f"(N,), got {tuple(x.shape)}, {tuple(w.shape)} and "
                         f"{tuple(s.shape)}")
    if not x.dtype == w.dtype == s.dtype == torch.float32:
        raise TypeError(f"scaled_matmul takes float32, got {x.dtype}, "
                        f"{w.dtype}, {s.dtype}")
    if not x.device == w.device == s.device:
        raise ValueError(f"x on {x.device}, w on {w.device}, s on "
                         f"{s.device}")
    return ScaledMatmul.apply(x, w, s)
