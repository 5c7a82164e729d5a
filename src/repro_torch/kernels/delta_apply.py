"""Fused dequantize + apply of an int8-blockscale update, the port of
``repro/kernels/delta_compress.py::delta_apply``:

    out = w + coef * (q * scales[i // block])

``delta_apply_leaves`` applies it to a list of leaves of any shapes, each
with its own levels and block scales and one ``coef`` for all, in ONE
launch of the hand-written CUDA kernel of ``csrc/delta_apply.cu`` per
``MAX_LEAVES`` leaves on CUDA tensors; on CPU tensors it uses the plain
PyTorch version beside it (``delta_apply_plain`` per leaf); any other
device raises.  ``delta_apply`` is the same for one flat leaf.  ``n`` may
be ragged: ``scales`` has ``ceil(n / block)`` entries, the layout
``delta_compress`` emits and the ``int8-blockscale`` wire carries (its
block is 128).

On the port's path the server applies the decoded int8 broadcast with
``coef = +1`` and the downlink forms its error-feedback residual with
``coef = -1``: one ``delta_apply_leaves`` call each per broadcast, over
the payload's sections (``fl.rounds.apply_int8_tree``).

``LAUNCHES`` counts kernel launches (only where the CUDA kernel is
launched); ``CALLS`` counts leaves as the plain version applies them, on
any device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, grouped
from repro_torch.kernels.grouped import array, leaf_offsets, views

CHUNK = 1024           # elements per CTA

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


def delta_apply_leaves_plain(ws, qs, scales, coef: float,
                             block: int) -> list[torch.Tensor]:
    """The grouped function in tensor ops: ``delta_apply_plain`` on each
    leaf, flattened, with the levels cut to the leaf's size."""
    return [delta_apply_plain(w.reshape(-1), q[:w.numel()], s, coef,
                              block).reshape(w.shape)
            for w, q, s in zip(ws, qs, scales)]


# ------------------------------------------------------------ CUDA kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("delta_apply")
    fn = lib.delta_apply_leaves_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch_leaves(ws, qs, scales, coef: float,
                   block: int) -> list[torch.Tensor]:
    dev = ws[0].device
    sizes = [w.numel() for w in ws]
    offsets, total = leaf_offsets(sizes)
    out = torch.empty(total, dtype=torch.float32, device=dev)
    cols = [[t if t.is_contiguous() else t.contiguous() for t in col]
            for col in (ws, qs, scales)]
    ptrs = [[t.data_ptr() for t in col] for col in cols]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi, starts in grouped.chunk_table(sizes, CHUNK):
            if starts[-1] == 0:      # only empty leaves
                continue
            err = lib.delta_apply_leaves_launch(
                hi - lo, *(array(ctypes.c_uint64, p[lo:hi]) for p in ptrs),
                array(ctypes.c_int64, sizes[lo:hi]),
                array(ctypes.c_int64, offsets[lo:hi]),
                array(ctypes.c_int, starts), out.data_ptr(), block,
                float(coef), stream)
            if err:
                raise RuntimeError(f"delta_apply kernel launch failed: CUDA "
                                   f"error {err}")
            LAUNCHES["delta_apply"] += 1
    return views(out, offsets, ws)


def _check(ws, qs, scales, block: int) -> None:
    if not len(ws) == len(qs) == len(scales):
        raise ValueError(f"delta_apply_leaves takes as many levels and scales "
                         f"as leaves, got {len(ws)}, {len(qs)} and "
                         f"{len(scales)}")
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    dev = ws[0].device if ws else None
    for w, q, s in zip(ws, qs, scales):
        if not dev == w.device == q.device == s.device:
            raise ValueError(f"delta_apply takes tensors on one device, got "
                             f"{dev}, {w.device}, {q.device}, {s.device}")
        if (w.dtype != torch.float32 or q.dtype != torch.int8
                or s.dtype != torch.float32):
            raise TypeError(f"delta_apply takes float32 w and scales and "
                            f"int8 q, got {w.dtype}, {q.dtype}, {s.dtype}")
        n = w.numel()
        if q.ndim != 1 or q.shape[0] not in (n, n + (-n) % block):
            raise ValueError(f"a leaf of {n} elements takes ({n},) levels "
                             f"or the block's padding of them, got "
                             f"{tuple(q.shape)}")
        nblk = -(-n // block)
        if s.shape != (nblk,):
            raise ValueError(f"scales must be ({nblk},) for n = {n} and "
                             f"block {block}, got {tuple(s.shape)}")


def delta_apply_leaves(ws, qs, scales, coef: float = 1.0, *,
                       block: int = 128) -> list[torch.Tensor]:
    """``w + coef * q * scale`` for each leaf: ws float32 tensors of any
    shapes, qs their int8 levels (flat, ``w.numel()`` of them or padded to
    the block, as the wire's sections), scales their ``ceil(n / block)``
    float32 block scales, all on one device.  Returns float32 tensors
    shaped as ws; on the card they are views of one flat buffer, from one
    launch per ``MAX_LEAVES`` leaves."""
    ws, qs, scales = list(ws), list(qs), list(scales)
    _check(ws, qs, scales, block)
    CALLS["delta_apply"] += len(ws)
    if not ws:
        return []
    dev = ws[0].device
    if dev.type == "cpu":
        return delta_apply_leaves_plain(ws, qs, scales, coef, block)
    if dev.type != "cuda":
        raise ValueError(f"delta_apply runs on CUDA or CPU tensors, got {dev}")
    return _launch_leaves(ws, qs, scales, coef, block)


def delta_apply(w: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                coef: float = 1.0, *, block: int = 128) -> torch.Tensor:
    """w (n,) float32, q (n,) int8, scales (ceil(n/block),) float32 ->
    ``w + coef * q * scale`` (n,) float32: the grouped function on one
    leaf."""
    if w.ndim != 1 or q.shape != w.shape:
        raise ValueError(f"delta_apply takes w and q of one (n,) shape, got "
                         f"{tuple(w.shape)} and {tuple(q.shape)}")
    return delta_apply_leaves([w], [q], [scales], coef, block=block)[0]
