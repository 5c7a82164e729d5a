"""Device-resident cohort encode: the uplink's fast path.

Port of ``repro.comms.device``.  The stacked RoundOutput stays on the
device until ONE device-to-host copy per cohort:

  ``int8-blockscale``  ONE ``int8_encode_leaves`` launch reads the
                       cohort's stacked leaves in place and writes the
                       (K, L) payload bodies (each params leaf's levels
                       zero-padded to a block multiple, so each 128-block
                       sits inside one leaf, then its block scales; then
                       the raw scales section).  The per-client
                       ``Codec.encode`` makes the same launch with K = 1.
  ``golomb``           int32 zigzag of the stacked levels on the device
                       (exact while every |level| < 2**30; the range
                       guard returns ``None`` otherwise and the uplink
                       takes the host int64 path, as the reference does),
                       then per row ``choose_k``/``encode_egk`` on the host.
  ``nnc-cabac``        CABAC pass-1 row-skip flags of every structured
                       tensor on the device, handed with the levels to
                       ``nnc.encode_leaves_batch``: exact booleans, so the
                       bins and bytes are the host path's.

Ternary messages get their per-tensor maxima on the device as well.  Under
wire schema v2 each row is framed with the client's BN statistics: the
cohort's BN rows come to the host in one copy (for the level codecs in
the same copy as the levels).  Every payload is byte-identical to the
host ``Codec.encode``.

``dispatch_count()`` counts the fused cohort programs launched here; the
uplink differences it around each cohort.
"""
from __future__ import annotations

import sys
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.coding import golomb as golomb_lib
from repro_torch.coding import nnc
from repro_torch.coding.bitstream import BitWriter
from repro_torch.comms.codec import (WireSpec, check_batch_clients,
                                     cohort_size, frame, sorted_items)
from repro_torch.kernels.delta_compress import int8_encode_leaves

_dispatches = 0
_ZIGZAG_SAFE = 2 ** 30   # |level| bound for an exact int32 zigzag


def dispatch_count() -> int:
    """Total fused cohort programs launched by this module (monotone)."""
    return _dispatches


def as_tensor(leaf: Any) -> torch.Tensor:
    """A tensor as it is (keeping its device), or a numpy leaf on the CPU."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.tensor(np.asarray(leaf, np.float32))


def int8_rows(p_leaves: list[torch.Tensor], s_leaves: list[torch.Tensor],
              block: int, *, batched: bool) -> np.ndarray:
    """(K, payload) uint8 of v1 ``int8-blockscale`` bodies.

    ``p_leaves``/``s_leaves`` are client-stacked (K, ...) params and scales
    leaves in wire order.  Per params leaf the body holds its padded int8
    levels then its float32 block scales; the raw float32 scales section
    follows.  One kernel launch and one device-to-host copy; ``batched``
    counts the call as a cohort's, else as one message's (K = 1).
    """
    if sys.byteorder != "little":
        raise RuntimeError("the wire format is little-endian")
    return int8_encode_leaves(p_leaves, s_leaves, 0.0, block,
                              batched=batched).cpu().numpy()


def bn_stack(bn_state: Any, spec: WireSpec, k: int) -> torch.Tensor | None:
    """(K, B) float32: each client's BN leaves, flat, in the v2 tail's
    sorted-path order; ``None`` when the spec carries no BN section."""
    if spec.version == 1 or spec.bn is None:
        return None
    by_path = dict(sorted_items(bn_state))
    return torch.cat([by_path[p].reshape(k, -1).to(torch.float32)
                      for p, _ in spec.bn_items()], dim=1)


def bn_rows(bn_state: Any, spec: WireSpec, k: int) -> np.ndarray | None:
    """:func:`bn_stack` on the host, in one device-to-host copy."""
    stack = bn_stack(bn_state, spec, k)
    return None if stack is None else stack.cpu().numpy()


def _frame_row(body: bytes, bn_host: np.ndarray | None, i: int,
               spec: WireSpec) -> bytes:
    if spec.version == 1:
        return body
    tail = (b"" if bn_host is None
            else np.ascontiguousarray(bn_host[i]).astype("<f4").tobytes())
    return frame(body, tail, spec)


def int8_encode_cohort(codec, out: Any, spec: WireSpec, *,
                       clients: Sequence[int] | None = None) -> list[bytes]:
    """Cohort encode for ``Int8BlockScaleCodec``: one kernel launch and one
    device-to-host copy (under v2 one more copy, of the BN rows)."""
    global _dispatches
    k = cohort_size(out)
    check_batch_clients(clients, k, "cohort rows")
    p_leaves = [leaf for p, leaf in sorted_items(out.recon_delta_params)
                if p in spec.sent_paths]
    s_leaves = ([leaf for _, leaf in sorted_items(out.recon_delta_scales)]
                if spec.scales is not None else [])
    bn_host = bn_rows(out.bn_state, spec, k)
    if not p_leaves and not s_leaves:
        return [_frame_row(b"", bn_host, i, spec) for i in range(k)]
    rows = int8_rows(p_leaves, s_leaves, codec.block, batched=True)
    if p_leaves:
        _dispatches += 1
    return [_frame_row(rows[i].tobytes(), bn_host, i, spec)
            for i in range(k)]


# ---------------------------------------------------------------- level codecs

def _level_stacks(out: Any, spec: WireSpec) -> list[torch.Tensor]:
    """Stacked level sections in wire order: sorted sent params paths,
    then sorted scales paths (the order of the ``{"p", "s"}`` message)."""
    p = [leaf for path, leaf in sorted_items(out.levels_params)
         if path in spec.sent_paths]
    s = ([leaf for _, leaf in sorted_items(out.levels_scales)]
         if spec.scales is not None else [])
    return p + s


def _ternary_maxima(out: Any, spec: WireSpec, k: int):
    """(K, L) float32 max |recon| per sent params tensor, or None."""
    if not spec.ternary:
        return None
    leaves = [leaf for path, leaf in sorted_items(out.recon_delta_params)
              if path in spec.sent_paths]
    if not leaves:
        return None
    return torch.stack([torch.amax(torch.abs(leaf.reshape(k, -1)
                                             .to(torch.float32)), dim=1)
                        for leaf in leaves], dim=1)


def _fetch(parts: list[torch.Tensor]) -> list[np.ndarray]:
    """(K, w_i) int32 device blocks -> host numpy blocks, in ONE copy
    (float32 blocks travel as their int32 bit patterns)."""
    if not parts:
        return []
    host = torch.cat(parts, dim=1).cpu().numpy()
    out, off = [], 0
    for part in parts:
        out.append(host[:, off:off + part.shape[1]])
        off += part.shape[1]
    return out


def _ternary_tail_row(tern: np.ndarray | None, i: int) -> bytes:
    if tern is None:
        return b""
    return np.ascontiguousarray(tern[i].view(np.float32)).astype(
        "<f4").tobytes()


def golomb_stream(zigzagged: list[np.ndarray]) -> bytes:
    """The golomb body: per section its 4-bit k, then its codewords."""
    w = BitWriter()
    for vals in zigzagged:
        k = golomb_lib.choose_k(vals)
        w.put_uint(k, 4)
        golomb_lib.encode_egk(w, vals, k)
    return w.to_bytes()


def golomb_encode_cohort(codec, out: Any, spec: WireSpec, *,
                         clients: Sequence[int] | None = None
                         ) -> list[bytes] | None:
    """Cohort encode for ``GolombCodec``; ``None`` when the zigzag range
    guard fails (the uplink then encodes on the host, as the reference)."""
    global _dispatches
    k = cohort_size(out)
    check_batch_clients(clients, k, "cohort rows")
    leaves = _level_stacks(out, spec)
    if not leaves:
        return None          # degenerate spec; the host path handles it
    buf = torch.cat([leaf.reshape(k, -1).to(torch.int32) for leaf in leaves],
                    dim=1)
    if buf.numel():
        in_range = (buf.max() < _ZIGZAG_SAFE) & (buf.min() > -_ZIGZAG_SAFE)
    else:
        in_range = torch.ones((), dtype=torch.bool, device=buf.device)
    zig = (buf << 1) ^ (buf >> 31)
    tern = _ternary_maxima(out, spec, k)
    bn = bn_stack(out.bn_state, spec, k)
    parts = [zig, in_range.to(torch.int32).expand(k, 1)]
    for extra in (tern, bn):
        if extra is not None:
            parts.append(extra.view(torch.int32))
    _dispatches += 1
    host = _fetch(parts)
    if not bool(host[1][0, 0]):
        return None          # the int32 zigzag would wrap
    zig_h = host[0].astype(np.int64)   # exact: guarded above
    extras = iter(host[2:])
    tern_h = next(extras) if tern is not None else None
    bn_h = next(extras).view(np.float32) if bn is not None else None
    sizes = [int(np.prod(leaf.shape[1:])) for leaf in leaves]
    payloads = []
    for i in range(k):
        sections, off = [], 0
        for n in sizes:
            sections.append(zig_h[i, off:off + n])
            off += n
        payloads.append(_frame_row(golomb_stream(sections)
                                   + _ternary_tail_row(tern_h, i),
                                   bn_h, i, spec))
    return payloads


def nnc_encode_cohort(codec, out: Any, spec: WireSpec, *,
                      clients: Sequence[int] | None = None) -> list[bytes]:
    """Cohort encode for ``NncCabacCodec``: row-skip flags on the device,
    one device-to-host copy, CABAC passes on the host."""
    global _dispatches
    k = cohort_size(out)
    check_batch_clients(clients, k, "cohort rows")
    leaves = _level_stacks(out, spec)
    shapes = [tuple(leaf.shape[1:]) for leaf in leaves]
    structured = [len(s) >= 2 for s in shapes]
    flags = []
    for leaf, shape, st in zip(leaves, shapes, structured):
        if st:
            m = shape[0]
            row_len = int(np.prod(shape[1:]))
            flags.append((leaf.reshape(k, m, row_len) != 0).any(dim=2)
                         .to(torch.int32))
    tern = _ternary_maxima(out, spec, k)
    bn = bn_stack(out.bn_state, spec, k)
    parts = ([leaf.reshape(k, -1).to(torch.int32) for leaf in leaves]
             + flags + [x.view(torch.int32) for x in (tern, bn)
                        if x is not None])
    _dispatches += 1
    host = _fetch(parts)
    n_lv, n_fl = len(leaves), len(flags)
    lv_h, fl_h = host[:n_lv], host[n_lv:n_lv + n_fl]
    extras = iter(host[n_lv + n_fl:])
    tern_h = next(extras) if tern is not None else None
    bn_h = next(extras).view(np.float32) if bn is not None else None
    leaf_lists, flag_lists = [], []
    for i in range(k):
        leaf_lists.append([lv[i].reshape(s) for lv, s in zip(lv_h, shapes)])
        row_flags, j = [], 0
        for st in structured:
            row_flags.append(fl_h[j][i].astype(bool) if st else None)
            j += int(st)
        flag_lists.append(row_flags)
    bodies = nnc.encode_leaves_batch(leaf_lists, row_flags=flag_lists)
    return [_frame_row(body + _ternary_tail_row(tern_h, i), bn_h, i, spec)
            for i, body in enumerate(bodies)]
