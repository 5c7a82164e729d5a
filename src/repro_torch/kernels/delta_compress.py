"""Fused threshold-sparsify + per-block int8 quantization (paper §3 wire
format), the port of ``repro/kernels/delta_compress.py``.

``int8_encode_leaves`` encodes a message's leaves, or a cohort's stacked
(K, ...) leaves, straight into v1 ``int8-blockscale`` wire bodies: per
params leaf its levels zero-padded to a block multiple, then its float32
block scales; then the raw float32 scales leaves.  On a CUDA tensor it is
ONE launch of the hand-written kernel of ``csrc/delta_compress.cu`` per
``MAX_LEAVES`` leaves, which reads the leaves in place and writes the
bodies in place; on a CPU tensor it takes the plain PyTorch version beside
it (``int8_encode_leaves_plain``); any other device raises.

``delta_compress`` (one client, (n,)) and ``delta_compress_batch`` (a
cohort, (K, n)) are the one-leaf case of the same launch, for every block
from 128 to 1024; their levels and scales are views of the body.  A zero
pad never wins the block maximum and quantizes to 0, and an all-pad block
gets the scale-1 sentinel.  Row i of a batch result is bit-equal to
``delta_compress(deltas[i])``.

``LAUNCHES`` counts kernel launches (only where the CUDA kernel is
launched), ``CALLS`` wrapper calls on any device: under
``"delta_compress"`` one a message, under ``"delta_compress_batch"`` one
a cohort.  The counts take a lock: a thread-pooled uplink encodes
messages concurrently.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, grouped
from repro_torch.kernels.grouped import MAX_LEAVES, array

WARPS_PER_CTA = 8
CHUNK = 128                    # elements a warp covers in one slot
PER_WARP = (1, 2)              # slots a warp: the kernel's template argument
CTAS_PER_SM = 8                # resident 256-thread CTAs an SM (2048 threads)

LAUNCHES = {"delta_compress": 0, "delta_compress_batch": 0}
CALLS = {"delta_compress": 0, "delta_compress_batch": 0}
_COUNTS_LOCK = threading.Lock()


def _count(counts: dict, name: str) -> None:
    with _COUNTS_LOCK:
        counts[name] += 1


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


def body_layout(p_sizes, s_sizes, block: int):
    """Byte offsets in one body row: of each params leaf's levels and
    block scales, then of each raw leaf's floats (its scales offset 0); and
    the row's length.  Every offset, and the length, is a multiple of 4."""
    q_offs, s_offs, off = [], [], 0
    for n in p_sizes:
        padded = -(-n // block) * block
        q_offs.append(off)
        s_offs.append(off + padded)
        off += padded + 4 * (padded // block)
    for n in s_sizes:
        q_offs.append(off)
        s_offs.append(0)
        off += 4 * n
    return q_offs, s_offs, off


def _sizes(leaves) -> list[int]:
    return [math.prod(t.shape[1:]) for t in leaves]


def int8_encode_leaves_plain(p_leaves, s_leaves, theta: float,
                             block: int) -> torch.Tensor:
    """The grouped function in tensor ops, on the leaves' device: every
    params leaf padded to a block multiple, all concatenated, one
    ``delta_compress_batch_plain``, and the body assembled from its
    sections and the raw scales leaves."""
    k = (p_leaves or s_leaves)[0].shape[0]
    dev = (p_leaves or s_leaves)[0].device
    if k == 0:
        length = body_layout(_sizes(p_leaves), _sizes(s_leaves), block)[2]
        return torch.zeros((0, length), dtype=torch.uint8, device=dev)
    chunks = []
    if p_leaves:
        flats, widths = [], []
        for leaf, n in zip(p_leaves, _sizes(p_leaves)):
            pad = (-n) % block
            widths.append(n + pad)
            flats.append(F.pad(leaf.reshape(k, n), (0, pad)))
        q, s = delta_compress_batch_plain(torch.cat(flats, dim=1), theta,
                                          block)
        qo = so = 0
        for w in widths:
            chunks.append(q[:, qo:qo + w].view(torch.uint8))
            chunks.append(s[:, so:so + w // block].contiguous()
                          .view(torch.uint8))
            qo += w
            so += w // block
    for leaf, n in zip(s_leaves, _sizes(s_leaves)):
        chunks.append(leaf.reshape(k, n).contiguous().view(torch.uint8))
    return torch.cat(chunks, dim=1)


# ------------------------------------------------------------ launch table

def groups_per_cta(block: int) -> int:
    """Groups of ``block // 128`` warps in a CTA of 8 warps."""
    return WARPS_PER_CTA // (block // CHUNK)


def launch_ctas(sizes, block: int, per_warp: int) -> int:
    """CTAs of one row of a launch: each entry's groups (``per_warp``
    blocks each), packed ``groups_per_cta`` to a CTA."""
    groups = sum(-(-n // (per_warp * block)) for n in sizes)
    return -(-groups // groups_per_cta(block))


def pick_per_warp(sizes, rows: int, block: int, sms: int) -> int:
    """The fewest slots a warp that keep the grid within two waves of a
    card of ``sms`` SMs (``CTAS_PER_SM`` CTAs each), else the most.  On an
    H100 (132 SMs), a message of ``vgg11_thinned`` runs fastest at 1 (834
    CTAs) and a cohort of 4 at 2 (1,680 CTAs, 1.6 waves); 4 slots were
    slower at both shapes and are not built (PERF.md §6)."""
    for w in PER_WARP:
        if rows * launch_ctas(sizes, block, w) <= 2 * sms * CTAS_PER_SM:
            return w
    return PER_WARP[-1]


def encode_table(sizes, n_params: int, ptrs, rows: int, block: int,
                 per_warp: int, cap: int = MAX_LEAVES):
    """The launches of one encode over its entries (the ``n_params``
    params leaves, then the raw leaves): for each run of at most ``cap``,
    ``(first entry, end entry, group starts, raw bits, vec bits)``, a
    group covering ``per_warp`` blocks of an entry's row, the bits
    relative to the run's first entry.  An entry takes float4 loads (its
    vec bit) when its pointer is 16-byte aligned and every row starts on
    a 16-byte boundary (one row, or a size that is a multiple of 4)."""
    out = []
    for lo, hi, starts in grouped.chunk_table(sizes, per_warp * block, cap):
        raw = vec = 0
        for i in range(lo, hi):
            if i >= n_params:
                raw |= 1 << (i - lo)
            if ptrs[i] % 16 == 0 and (rows == 1 or sizes[i] % 4 == 0):
                vec |= 1 << (i - lo)
        out.append((lo, hi, starts, raw, vec))
    return out


# ------------------------------------------------------------ CUDA kernel

def _lib() -> ctypes.CDLL:
    lib = build.load("delta_compress")
    fn = lib.int8_encode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
                          ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_block(block: int) -> None:
    if block % CHUNK or not CHUNK <= block <= CHUNK * WARPS_PER_CTA:
        raise ValueError(f"block must be a multiple of 128 in [128, 1024], "
                         f"got {block}")


def _launch(leaves, n_params: int, theta: float, block: int,
            name: str) -> torch.Tensor:
    """(K, L) uint8 bodies of stacked float32 CUDA leaves (the first
    ``n_params`` quantized, the rest copied raw); counts each launch under
    ``name``."""
    k = leaves[0].shape[0]
    sizes = _sizes(leaves)
    q_offs, s_offs, length = body_layout(sizes[:n_params], sizes[n_params:],
                                         block)
    dev = leaves[0].device
    body = torch.empty((k, length), dtype=torch.uint8, device=dev)
    if k == 0 or length == 0:
        return body
    if k > 65535:
        raise ValueError(f"at most 65535 rows per launch, got {k}")
    leaves = [t if t.is_contiguous() else t.contiguous() for t in leaves]
    ptrs = [t.data_ptr() for t in leaves]
    w = pick_per_warp(sizes, k, block,
                      torch.cuda.get_device_properties(dev)
                      .multi_processor_count)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi, starts, raw, vec in encode_table(sizes, n_params, ptrs,
                                                     k, block, w):
            if starts[-1] == 0:      # only empty leaves
                continue
            cols = (array(ctypes.c_int64, c[lo:hi])
                    for c in (sizes, sizes, q_offs, s_offs))
            err = lib.int8_encode_launch(
                hi - lo, array(ctypes.c_uint64, ptrs[lo:hi]), *cols,
                array(ctypes.c_int, starts), raw, vec, body.data_ptr(), k,
                length, block, w, float(theta), stream)
            if err:
                raise RuntimeError(f"delta_compress kernel launch failed: "
                                   f"CUDA error {err}")
            _count(LAUNCHES, name)
    return body


def _check_leaves(leaves, name: str) -> None:
    if not leaves:
        raise ValueError(f"{name} takes at least one leaf")
    first = leaves[0]
    for t in leaves:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 leaves, got {t.dtype}")
        if t.ndim < 1 or t.shape[0] != first.shape[0]:
            raise ValueError(f"{name} takes (K, ...) leaves of one K, got "
                             f"shapes {tuple(first.shape)} and "
                             f"{tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError(f"{name} takes leaves on one device, got "
                             f"{first.device} and {t.device}")


def int8_encode_leaves(p_leaves, s_leaves, theta: float, block: int = 128,
                       *, batched: bool = True) -> torch.Tensor:
    """(K, L) uint8 v1 ``int8-blockscale`` bodies of client-stacked
    float32 leaves in wire order: ``p_leaves`` quantized per ``block``
    with threshold ``theta``, ``s_leaves`` copied raw.  On the leaves'
    device; on the card one launch per ``MAX_LEAVES`` leaves.  Counted
    under ``"delta_compress_batch"`` (a cohort) or, with ``batched``
    False, under ``"delta_compress"`` (one message, K = 1)."""
    p_leaves, s_leaves = list(p_leaves), list(s_leaves)
    name = "delta_compress_batch" if batched else "delta_compress"
    _check_leaves(p_leaves + s_leaves, name)
    _check_block(block)
    k = (p_leaves or s_leaves)[0].shape[0]
    if not batched and k != 1:
        raise ValueError(f"a single message is one row, got {k}")
    _count(CALLS, name)
    dev = (p_leaves or s_leaves)[0].device
    if dev.type == "cpu":
        return int8_encode_leaves_plain(p_leaves, s_leaves, theta, block)
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {dev}")
    return _launch(p_leaves + s_leaves, len(p_leaves), theta, block, name)


# ------------------------------------------------------------ one buffer

def _dispatch(deltas: torch.Tensor, theta: float, block: int, name: str):
    if deltas.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 deltas, got {deltas.dtype}")
    _check_block(block)
    _count(CALLS, name)
    if deltas.device.type == "cpu":
        return delta_compress_batch_plain(deltas, theta, block)
    if deltas.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{deltas.device}")
    k, n = deltas.shape
    if k == 0 or n == 0:
        return (torch.zeros((k, 0), dtype=torch.int8, device=deltas.device),
                torch.zeros((k, 0), dtype=torch.float32,
                            device=deltas.device))
    body = _launch([deltas], 1, theta, block, name)
    padded = -(-n // block) * block
    return body[:, :n].view(torch.int8), body[:, padded:].view(torch.float32)


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
