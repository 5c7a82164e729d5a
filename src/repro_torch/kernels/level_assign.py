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

``level_assign_leaves`` applies it to a list of leaves of any shapes, each
with its own threshold (one float32 a leaf in a device tensor) and its own
step (by value, the float32 of ``quant.f32``), in one launch per
``MAX_LEAVES`` leaves; its plain version is the loop of
``level_assign_plain`` over the leaves.  The client round and the
downlink call it once per client and per broadcast
(``comms.stages.UpstreamStages.compress_carry``).  Given a (K, L) theta
tensor it takes a cohort's leaves instead, each stacked over the K
clients, one theta per client and leaf: one launch for the cohort, its
rows on the grid's y axis, each row bitwise the launch over that row
alone, each leaf's rows one contiguous (K, ...) block of the outputs
(``compress_carry_cohort``, the batched client round).

``LAUNCHES`` counts kernel launches (only where the CUDA kernel is
launched); ``CALLS`` counts the function as the plain version applies it,
once per (K, n) call and once per leaf (and cohort row), on any device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, grouped
from repro_torch.kernels.grouped import (MAX_LEAVES, array, leaf_offsets,
                                         views)

MAX_LEVEL = 2**23
CHUNK = 1024           # elements per CTA
LAUNCHES = {"level_assign": 0}
CALLS = {"level_assign": 0}


def reset_counters() -> None:
    for counts in (LAUNCHES, CALLS):
        for k in counts:
            counts[k] = 0


def _scalar(x, device: torch.device,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x`` (a float or a one-element tensor) as a (1,) tensor of
    ``dtype`` on ``device``."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if t.numel() != 1:
        raise ValueError(f"theta and step are scalars, got shape "
                         f"{tuple(t.shape)}")
    return t.reshape(1)


def _check_dtypes(name: str, tensors, device: torch.device) -> None:
    """float32 for the kernel; on the CPU the plain version takes any one
    floating type (float64 where the port is held against the reference
    under ``jax.enable_x64``)."""
    dtypes = {t.dtype for t in tensors}
    if device.type == "cpu" and len(dtypes) == 1 and (
            next(iter(dtypes)).is_floating_point):
        return
    if dtypes != {torch.float32}:
        raise TypeError(f"{name} takes float32 tensors (on the CPU, tensors "
                        f"of one floating type), got "
                        f"{sorted(str(d) for d in dtypes)}")


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
    carried = deltas + residuals
    # float32 as the kernel; a wider carry (the reference under x64) keeps
    # its own type for theta and the step, and float32 for the levels'
    # reconstruction, as ``quant.dequantize``
    wide = carried.dtype
    th = _scalar(theta, dev, wide)
    return _assign(carried, th, step, max_level)


def _assign(carried, th, step, max_level: int):
    """Threshold, quantize and carry of ``carried`` (K, n) with ``th`` of
    one element or (K, 1), one threshold a row."""
    dev, wide = carried.device, carried.dtype
    st, st32 = _scalar(step, dev, wide), _scalar(step, dev)
    kept = torch.where(torch.abs(carried) >= th, carried, 0.0)
    lv = torch.clamp(torch.round(kept / st), -max_level, max_level)
    return lv.to(torch.int32), carried - lv.to(torch.float32) * st32


def level_assign_leaves_plain(deltas, residuals, thetas: torch.Tensor,
                              steps, max_level: int = MAX_LEVEL):
    """The grouped function in tensor ops: ``level_assign_plain`` on each
    leaf, flattened to one row, with its own theta and step; with (K, L)
    thetas, each leaf's K rows, row k with its theta ``thetas[k, l]``."""
    levels, carries = [], []
    cohort = thetas.ndim == 2
    for i, (d, r, step) in enumerate(zip(deltas, residuals, steps)):
        if cohort:
            k = d.shape[0]
            carried = d.reshape(k, -1) + r.reshape(k, -1)
            if carried.numel() == 0:
                lv, c = _empty(k, carried.shape[1], d.device)
            else:
                lv, c = _assign(carried, thetas[:, i].to(
                    carried.dtype).reshape(k, 1), step, max_level)
        else:
            lv, c = level_assign_plain(d.reshape(1, -1), r.reshape(1, -1),
                                       thetas[i], step, max_level)
        levels.append(lv.reshape(d.shape))
        carries.append(c.reshape(d.shape))
    return levels, carries


def chunk_table(sizes, cap: int = MAX_LEAVES,
                chunk: int = CHUNK) -> list[tuple[int, int, list[int]]]:
    """The launches of the grouped kernel (``grouped.chunk_table`` with
    this kernel's 1,024-element CTA)."""
    return grouped.chunk_table(sizes, chunk, cap)


# ------------------------------------------------------------ CUDA kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("level_assign")
    fn = lib.level_assign_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.level_assign_leaves_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
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
    _check_dtypes("level_assign", [deltas, residuals], deltas.device)
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


def _launch_leaves(deltas, residuals, thetas, steps, max_level: int):
    dev = deltas[0].device
    cohort = thetas.ndim == 2
    rows = thetas.shape[0] if cohort else 1
    if rows > 65535:
        raise ValueError(f"at most 65535 cohort rows a launch, got {rows}")
    sizes = [d[0].numel() if cohort and rows else d.numel() for d in deltas]
    offsets, total = leaf_offsets(sizes)
    # each leaf's rows in one contiguous block, (K, ...) as the leaf
    blocks = [rows * o for o in offsets]
    levels = torch.empty(rows * total, dtype=torch.int32, device=dev)
    carry = torch.empty(rows * total, dtype=torch.float32, device=dev)
    if rows == 0:
        return views(levels, blocks, deltas), views(carry, blocks, deltas)
    ds = [d.contiguous() for d in deltas]
    rs = [r.contiguous() for r in residuals]
    th = thetas.contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi, starts in chunk_table(sizes):
            if starts[-1] == 0:      # only empty leaves
                continue
            err = lib.level_assign_leaves_launch(
                hi - lo,
                array(ctypes.c_uint64, [d.data_ptr() for d in ds[lo:hi]]),
                array(ctypes.c_uint64, [r.data_ptr() for r in rs[lo:hi]]),
                array(ctypes.c_int64, sizes[lo:hi]),
                array(ctypes.c_int64, offsets[lo:hi]),
                array(ctypes.c_float, steps[lo:hi]),
                array(ctypes.c_int, starts), th.data_ptr() + 4 * lo,
                levels.data_ptr(), carry.data_ptr(), float(max_level), rows,
                len(deltas), stream)
            if err:
                raise RuntimeError(f"level_assign kernel launch failed: "
                                   f"CUDA error {err}")
            LAUNCHES["level_assign"] += 1
    return views(levels, blocks, deltas), views(carry, blocks, deltas)


def level_assign_leaves(deltas, residuals, thetas: torch.Tensor, steps, *,
                        max_level: int = MAX_LEVEL):
    """``level_assign`` of each leaf: deltas and residuals are lists of
    float32 tensors (pairwise of one shape, any shapes), ``thetas`` a
    float32 (L,) tensor beside them, ``steps`` L floats.  Returns (levels
    int32, carry float32), two lists of tensors shaped as the leaves; on
    the card they are views of two flat buffers, from one launch per
    ``MAX_LEAVES`` leaves.  With ``thetas`` (K, L), every leaf is a
    cohort's, (K, ...), and row k of leaf l takes ``thetas[k, l]``: on the
    card one launch per ``MAX_LEAVES`` leaves for the whole cohort."""
    deltas, residuals, steps = list(deltas), list(residuals), [
        float(s) for s in steps]
    if not len(deltas) == len(residuals) == len(steps):
        raise ValueError(f"level_assign_leaves takes as many residuals and "
                         f"steps as deltas, got {len(deltas)}, "
                         f"{len(residuals)} and {len(steps)}")
    if thetas.ndim not in (1, 2) or thetas.shape[-1] != len(deltas) or (
            thetas.ndim == 2 and any(d.ndim == 0 or d.shape[0]
                                     != thetas.shape[0] for d in deltas)):
        raise ValueError(f"thetas must have shape ({len(deltas)},), or (K, "
                         f"{len(deltas)}) beside leaves of K rows, got "
                         f"{tuple(thetas.shape)}")
    tensors = deltas + residuals + [thetas]
    _check_dtypes("level_assign_leaves", tensors, thetas.device)
    if any(t.device != thetas.device for t in tensors):
        raise ValueError(f"level_assign_leaves takes tensors on one device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    for d, r in zip(deltas, residuals):
        if d.shape != r.shape:
            raise ValueError(f"a delta of shape {tuple(d.shape)} with a "
                             f"residual of shape {tuple(r.shape)}")
    if not 0 < max_level <= 2**24:
        raise ValueError(f"max_level must be in (0, 2**24], got {max_level}")
    CALLS["level_assign"] += len(deltas) * (
        thetas.shape[0] if thetas.ndim == 2 else 1)
    if thetas.device.type == "cpu":
        return level_assign_leaves_plain(deltas, residuals, thetas, steps,
                                         max_level)
    if thetas.device.type != "cuda":
        raise ValueError(f"level_assign runs on CUDA or CPU tensors, got "
                         f"{thetas.device}")
    if not deltas:
        return [], []
    return _launch_leaves(deltas, residuals, thetas, steps, max_level)
