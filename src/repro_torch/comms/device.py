"""Device-resident int8 encode: the uplink's fast path.

Port of ``repro.comms.device`` (``int8-blockscale`` only).  The stacked
RoundOutput stays on the device: every params leaf is zero-padded to a
block multiple (so each 128-block sits inside one leaf and the q/scale
chunks equal the per-client layout), the leaves are concatenated into one
(K, P) buffer, ONE ``delta_compress_batch`` launch quantizes the cohort,
the payload bytes are assembled on the device, and ONE device-to-host copy
brings every client's payload back.  Payloads are byte-identical to the
per-client ``Codec.encode``, which runs the same assembly with K = 1
through the single-row kernel.

``dispatch_count()`` counts the fused cohort programs launched here; the
uplink differences it around each cohort.
"""
from __future__ import annotations

import sys
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.comms.codec import (WireSpec, check_batch_clients,
                                     cohort_size, sorted_items)
from repro_torch.kernels.delta_compress import (delta_compress,
                                                delta_compress_batch)

_dispatches = 0


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
    follows.  ``batched`` picks the cohort kernel over the single-row one.
    """
    if sys.byteorder != "little":
        raise RuntimeError("the wire format is little-endian")
    k = (p_leaves or s_leaves)[0].shape[0]
    chunks: list[torch.Tensor] = []
    if p_leaves:
        flats, meta = [], []
        for leaf in p_leaves:
            flat = leaf.reshape(k, -1).to(torch.float32)
            pad = (-flat.shape[1]) % block
            meta.append((flat.shape[1] + pad, (flat.shape[1] + pad) // block))
            flats.append(F.pad(flat, (0, pad)) if pad else flat)
        buf = torch.cat(flats, dim=1)
        if batched:
            q, s = delta_compress_batch(buf, 0.0, block=block)
        else:
            if k != 1:
                raise ValueError("the single-row kernel encodes one client")
            q, s = delta_compress(buf[0], 0.0, block=block)
            q, s = q[None], s[None]
        qo = so = 0
        for padded, nblk in meta:
            chunks.append(q[:, qo:qo + padded].view(torch.uint8))
            chunks.append(s[:, so:so + nblk].contiguous().view(torch.uint8))
            qo += padded
            so += nblk
    for leaf in s_leaves:
        chunks.append(leaf.reshape(k, -1).to(torch.float32).contiguous()
                      .view(torch.uint8))
    return torch.cat(chunks, dim=1).cpu().numpy()


def int8_encode_cohort(codec, out: Any, spec: WireSpec, *,
                       clients: Sequence[int] | None = None) -> list[bytes]:
    """Cohort encode for ``Int8BlockScaleCodec``: one kernel launch, one
    device-to-host copy."""
    global _dispatches
    k = cohort_size(out)
    check_batch_clients(clients, k, "cohort rows")
    p_leaves = [leaf for p, leaf in sorted_items(out.recon_delta_params)
                if p in spec.sent_paths]
    s_leaves = ([leaf for _, leaf in sorted_items(out.recon_delta_scales)]
                if spec.scales is not None else [])
    if not p_leaves and not s_leaves:
        return [b""] * k
    rows = int8_rows(p_leaves, s_leaves, codec.block, batched=True)
    if p_leaves:
        _dispatches += 1
    return [rows[i].tobytes() for i in range(k)]
