"""The launch tables of the port's grouped kernels (``level_assign_leaves``,
``row_stats_leaves``, ``delta_apply_leaves``).

A grouped kernel takes the leaves of one client, or of one broadcast, in
one launch: their pointers, sizes and output offsets go in a by-value
table of at most ``MAX_LEAVES`` entries, and each CTA finds its leaf by a
binary search of the first CTA of each leaf.  These helpers compute that
table's offsets and CTA ranges, and cut the flat outputs back into one
view a leaf.
"""
from __future__ import annotations

import ctypes

import torch

MAX_LEAVES = 64        # leaves in one launch's by-value table


def leaf_offsets(sizes) -> tuple[list[int], int]:
    """Each leaf's offset in the flat outputs, rounded up to 4 elements so
    that every leaf starts 16-byte aligned, and the buffers' length."""
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 4) * 4
    return offsets, total


def chunk_table(sizes, chunk: int,
                cap: int = MAX_LEAVES) -> list[tuple[int, int, list[int]]]:
    """The launches of a grouped kernel whose CTA covers ``chunk`` units of
    a leaf (elements, or rows): ``(first leaf, end leaf, chunk starts)``
    for each run of at most ``cap`` leaves, the starts holding the first
    CTA of each leaf and, last, the launch's CTA count."""
    table = []
    for lo in range(0, len(sizes), cap):
        hi = min(lo + cap, len(sizes))
        starts = [0]
        for n in sizes[lo:hi]:
            starts.append(starts[-1] + -(-n // chunk))
        table.append((lo, hi, starts))
    return table


def views(flat: torch.Tensor, offsets, like) -> list[torch.Tensor]:
    """Contiguous views of ``flat`` at ``offsets`` shaped as ``like``
    (``as_strided``: one op a leaf, where a slice and a view take two)."""
    out = []
    for o, t in zip(offsets, like):
        strides, step = [], 1
        for n in reversed(t.shape):
            strides.append(step)
            step *= n
        out.append(flat.as_strided(t.shape, strides[::-1], o))
    return out


def array(ctype, values):
    """``values`` as a ctypes array, the by-value table's columns."""
    return (ctype * len(values))(*values)
