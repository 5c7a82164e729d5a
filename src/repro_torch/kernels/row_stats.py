"""Per-row mean ``|w|`` (the Eq. 3 filter scores), the port of
``repro/kernels/row_stats.py``.

``row_stats_leaves`` takes a list of ``(M, N)`` views, each of any shape,
and gives each view's scores from ONE launch of the hand-written CUDA
kernel of ``csrc/row_stats.cu`` per ``MAX_LEAVES`` views on CUDA tensors;
on CPU tensors it uses the plain PyTorch version beside it
(``row_stats_plain`` per view); any other device raises.  ``row_stats``
is the same for one view.  Each row's true sum is divided by ``N``: the
reference's padding to its TPU block sizes is not needed.  The kernel
sums in another order than ``torch.mean``, so the two agree to rtol 1e-6,
not bitwise.

On the port's path ``core.sparsify.sparsify_tree`` calls
``row_stats_leaves`` once per tree wherever the structured stage runs
(Eq. 3 thresholds and fixed-rate ``topk_rows``), on the ``(M, -1)`` view
of every leaf of two or more dimensions: once per client and once per
broadcast.  ``core.sparsify.row_scores`` calls ``row_stats`` on one leaf.

``LAUNCHES`` counts kernel launches (only where the CUDA kernel is
launched); ``CALLS`` counts views as the plain version scores them, on any
device.
"""
from __future__ import annotations

import ctypes
import itertools

import torch

from repro_torch.kernels import build, grouped
from repro_torch.kernels.grouped import array

ROWS = 8               # rows per CTA, one warp a row
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


def row_stats_leaves_plain(views) -> list[torch.Tensor]:
    """The grouped function in tensor ops: ``row_stats_plain`` per view."""
    return [row_stats_plain(w) for w in views]


# ------------------------------------------------------------ CUDA kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("row_stats")
    fn = lib.row_stats_leaves_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
    return lib


def _launch_leaves(views) -> list[torch.Tensor]:
    dev = views[0].device
    ws = [w if w.is_contiguous() else w.contiguous() for w in views]
    rows = [w.shape[0] for w in ws]
    cols = [w.shape[1] for w in ws]
    offsets = [0, *itertools.accumulate(rows)]
    out = torch.empty(offsets.pop(), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi, starts in grouped.chunk_table(rows, ROWS):
            if starts[-1] == 0:      # only views without rows
                continue
            err = lib.row_stats_leaves_launch(
                hi - lo,
                array(ctypes.c_uint64, [w.data_ptr() for w in ws[lo:hi]]),
                array(ctypes.c_int64, rows[lo:hi]),
                array(ctypes.c_int64, cols[lo:hi]),
                array(ctypes.c_int64, offsets[lo:hi]),
                array(ctypes.c_int, starts), out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"row_stats kernel launch failed: CUDA "
                                   f"error {err}")
            LAUNCHES["row_stats"] += 1
    return list(out.split(rows))


def _check(views) -> None:
    for w in views:
        if w.ndim != 2:
            raise ValueError(f"row_stats takes (M, N) tensors, got shape "
                             f"{tuple(w.shape)}")
        if w.dtype != torch.float32:
            raise TypeError(f"row_stats takes float32, got {w.dtype}")
    if any(w.device != views[0].device for w in views):
        raise ValueError(f"row_stats_leaves takes tensors on one device, "
                         f"got {sorted({str(w.device) for w in views})}")


def row_stats_leaves(views) -> list[torch.Tensor]:
    """views: float32 ``(M_i, N_i)`` tensors on one device -> their (M_i,)
    float32 mean ``|w|`` per row; on the card they are views of one flat
    buffer, from one launch per ``MAX_LEAVES`` views."""
    views = list(views)
    _check(views)
    CALLS["row_stats"] += len(views)
    if not views:
        return []
    dev = views[0].device
    if dev.type == "cpu":
        return row_stats_leaves_plain(views)
    if dev.type != "cuda":
        raise ValueError(f"row_stats runs on CUDA or CPU tensors, got {dev}")
    return _launch_leaves(views)


def row_stats(w: torch.Tensor) -> torch.Tensor:
    """w (M, N) float32 -> (M,) float32 mean ``|w|`` per row: the grouped
    function on one view."""
    return row_stats_leaves([w])[0]
