"""Matrix product with the per-output-row scaling factors of Eq. 4 applied
at matmul time, the port of ``repro/kernels/scaled_matmul.py``, with its
backward:

    y = x @ (s * W)^T          x (M, K), W (N, K), s (N,) -> (M, N)

or, for a cohort of B clients stacked on a leading axis, the same per row:
x (B, M, K), W (B, N, K), s (B, N) -> (B, M, N), one launch for the cohort
(the batched client round of ``fl.executors.VmapExecutor``).

``scaled_matmul`` is a ``torch.autograd.Function``.  Its forward launches
one hand-written CUDA kernel of ``csrc/scaled_matmul.cu`` on CUDA tensors,
and so does its backward, which computes in that one launch the gradients
asked for (``ctx.needs_input_grad``); on CPU tensors both take the plain
PyTorch versions beside them; any other device raises:

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

``LAUNCHES`` counts kernel launches, ``forward`` and ``backward`` (only
where a CUDA kernel is launched; a cohort's is one); ``CALLS`` counts the
products computed per direction (forward, dx, dw, ds) on any device, one
per cohort row.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DIRECTIONS = ("forward", "dx", "dw", "ds")
KERNELS = ("forward", "backward")
LAUNCHES = {k: 0 for k in KERNELS}
CALLS = {d: 0 for d in DIRECTIONS}


def reset_counters() -> None:
    for counts in (LAUNCHES, CALLS):
        for k in counts:
            counts[k] = 0


# ------------------------------------------------------------ plain versions

# each takes one product (2-D operands) or a cohort's (3-D, row by row)

def scaled_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """``x @ (s * W)^T``: the weight scaled first, as the reference's
    oracle."""
    return x @ (w * s[..., None]).transpose(-1, -2)


def dx_plain(dy: torch.Tensor, w: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """d x of ``x @ (s * W)^T``: ``dy @ (s * W)``."""
    return dy @ (w * s[..., None])


def dw_plain(dy: torch.Tensor, x: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """d W: ``s * (dy^T @ x)``."""
    return (dy.transpose(-1, -2) @ x) * s[..., None]


def ds_plain(dy: torch.Tensor, x: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """d s: the row sums of ``(dy^T @ x) * W``, which are ``sum_m dy[m, n]
    (x W^T)[m, n]``."""
    return torch.sum((dy.transpose(-1, -2) @ x) * w, dim=-1)


# ------------------------------------------------------------ CUDA kernels

def _lib() -> ctypes.CDLL:
    lib = build.load("scaled_matmul")
    fn = lib.scaled_matmul_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.scaled_matmul_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(kernel: str, err: int) -> None:
    if err:
        raise RuntimeError(f"scaled_matmul {kernel} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES[kernel] += 1


def _on_cpu(device: torch.device) -> bool:
    """True for a CPU tensor (the plain versions), False for a CUDA tensor
    (the kernels); raises on any other device."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"scaled_matmul runs on CUDA or CPU tensors, got "
                         f"{device}")
    return False


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _batch(t: torch.Tensor) -> tuple[int, tuple]:
    """A cohort's row count (1 for a 2-D operand) and its leading shape."""
    return (t.shape[0], t.shape[:1]) if t.ndim == 3 else (1, ())


def forward(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor):
    b, lead = _batch(x)
    CALLS["forward"] += b
    if _on_cpu(x.device):
        return scaled_matmul_plain(x, w, s)
    (m, k), n = x.shape[-2:], w.shape[-2]
    if min(b, m, n, k) == 0:     # an empty sum: nothing to launch
        return torch.zeros(lead + (m, n), dtype=torch.float32,
                           device=x.device)
    x, w, s = x.contiguous(), w.contiguous(), s.contiguous()
    y = torch.empty(lead + (m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().scaled_matmul_forward(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), b, m, n,
            k, torch.cuda.current_stream(x.device).cuda_stream)
    _check("forward", err)
    return y


def backward(dy: torch.Tensor, x, w, s, need_x: bool, need_w: bool,
             need_s: bool):
    """``(dx, dW, ds)`` of ``x @ (s * W)^T`` for the upstream gradient
    ``dy`` (M, N), or (B, M, N) for a cohort, each None unless asked for;
    on the card one launch computes all that are.  ``x`` (M, K) is read
    only for dW and ds, ``s`` only for dx and dW, so either may be None
    where it is not."""
    b, lead = _batch(dy)
    asked = {"dx": need_x, "dw": need_w, "ds": need_s}
    for d, need in asked.items():
        CALLS[d] += b * int(need)
    if _on_cpu(dy.device):
        # a float32 s beside float64 x and W (the reference's pinned
        # scales under x64): its gradient in float32, as autograd's
        return (dx_plain(dy, w, s) if need_x else None,
                dw_plain(dy, x, s) if need_w else None,
                ds_plain(dy, x, w).to(dy.dtype if s is None else s.dtype)
                if need_s else None)
    (m, n), k = dy.shape[-2:], (w if w is not None else x).shape[-1]
    shapes = {"dx": (m, k), "dw": (n, k), "ds": (n,)}
    out = {d: torch.empty(lead + shapes[d], dtype=torch.float32,
                          device=dy.device)
           if need else None for d, need in asked.items()}
    if not any(asked.values()) or min(b, m, n, k) == 0:   # nothing to launch
        return tuple(o.zero_() if o is not None else None
                     for o in out.values())
    dy, x, w, s = (t.contiguous() if t is not None else None
                   for t in (dy, x, w, s))
    with torch.cuda.device(dy.device):
        err = _lib().scaled_matmul_backward(
            dy.data_ptr(), _ptr(x), _ptr(w), _ptr(s), _ptr(out["dx"]),
            _ptr(out["dw"]), _ptr(out["ds"]), b, m, n, k,
            torch.cuda.current_stream(dy.device).cuda_stream)
    _check("backward", err)
    return tuple(out.values())


def dx(dy: torch.Tensor, w: torch.Tensor, s: torch.Tensor):
    """``backward`` for dx alone."""
    return backward(dy, None, w, s, True, False, False)[0]


def dw(dy: torch.Tensor, x: torch.Tensor, s: torch.Tensor):
    """``backward`` for dW alone."""
    return backward(dy, x, None, s, False, True, False)[1]


def ds(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor):
    """``backward`` for ds alone."""
    return backward(dy, x, w, None, False, False, True)[2]


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
        return backward(dy, x, w, s, *ctx.needs_input_grad[:3])


def scaled_matmul(x: torch.Tensor, w: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """x (M, K), w (N, K), s (N,) float32 on one device -> (M, N) float32
    ``x @ (s * W)^T``, differentiable in all three; or a cohort's, x (B, M,
    K), w (B, N, K), s (B, N) -> (B, M, N), in one launch each way."""
    lead = x.shape[:-2]
    if x.ndim not in (2, 3) or w.ndim != x.ndim or s.ndim != x.ndim - 1 or (
            w.shape[:-2] != lead or s.shape[:-1] != lead
            or s.shape[-1] != w.shape[-2] or x.shape[-1] != w.shape[-1]):
        raise ValueError(f"scaled_matmul takes x (M, K), w (N, K) and s "
                         f"(N,), or x (B, M, K), w (B, N, K) and s (B, N), "
                         f"got {tuple(x.shape)}, {tuple(w.shape)} and "
                         f"{tuple(s.shape)}")
    if x.ndim == 3 and x.shape[0] > 65535:
        raise ValueError(f"at most 65535 cohort rows a launch, got "
                         f"{x.shape[0]}")
    cpu_wide = (x.device.type == "cpu" and x.dtype == w.dtype
                and x.dtype.is_floating_point
                and s.dtype in (torch.float32, x.dtype))
    if not (cpu_wide or x.dtype == w.dtype == s.dtype == torch.float32):
        raise TypeError(f"scaled_matmul takes float32 (on the CPU, x and w "
                        f"of one floating type with s of it or float32), "
                        f"got {x.dtype}, {w.dtype}, {s.dtype}")
    if not x.device == w.device == s.device:
        raise ValueError(f"x on {x.device}, w on {w.device}, s on "
                         f"{s.device}")
    return ScaledMatmul.apply(x, w, s)
