"""The registered wire codecs of the port (the float codecs).

Port of ``repro.comms.codecs``:

  raw-fp32         little-endian float32 of the reconstruction; lossless.
  fp16             float16 params section (scales stay float32).
  int8-blockscale  per-128-block symmetric int8 through the fused kernel
                   (``kernels/delta_compress.py``; threshold 0, the graph
                   stages already sparsified), then the block scales and a
                   raw float32 scales section.

The level codecs (golomb, nnc-cabac) need ``coding/`` and are not ported
yet; asking for them raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comms import device as comms_device
from repro_torch.comms.codec import (ClientUpdate, Codec, Decoded, WireSpec,
                                     rebuild_tree, register_codec,
                                     sorted_items)


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def _sent_recon_items(upd: ClientUpdate, spec: WireSpec):
    """Encoder-side (path, recon leaf) pairs in wire order."""
    return [(p, leaf) for p, leaf in sorted_items(upd.recon_params)
            if p in spec.sent_paths]


def _encode_scales_fp32(upd: ClientUpdate, spec: WireSpec) -> list[bytes]:
    if spec.scales is None:
        return []
    return [np.ascontiguousarray(_np32(leaf).astype("<f4")).tobytes()
            for _, leaf in sorted_items(upd.recon_scales)]


def _decode_scales_fp32(payload: bytes, off: int, spec: WireSpec):
    """Inverse of :func:`_encode_scales_fp32`; returns (scales, off)."""
    if spec.scales is None:
        return None, off
    by_s: dict[str, np.ndarray] = {}
    for path, s in spec.scale_items():
        n = int(np.prod(s.shape)) if s.shape else 1
        by_s[path] = (np.frombuffer(payload, "<f4", n, off)
                      .astype(np.float32).reshape(s.shape))
        off += n * 4
    return rebuild_tree(spec.scales, by_s), off


class RawFloatCodec(Codec):
    """Raw little-endian floats, params in ``param_dtype``, scales float32."""

    def __init__(self, name: str, param_dtype: str):
        self.name = name
        self.param_dtype = param_dtype

    def _encode_body(self, upd: ClientUpdate, spec: WireSpec) -> bytes:
        chunks = [np.ascontiguousarray(_np32(leaf).astype(self.param_dtype))
                  .tobytes() for _, leaf in _sent_recon_items(upd, spec)]
        chunks += _encode_scales_fp32(upd, spec)
        return b"".join(chunks)

    def _decode_body(self, payload: bytes, spec: WireSpec) -> Decoded:
        off = 0
        itemsize = np.dtype(self.param_dtype).itemsize
        by_path: dict[str, np.ndarray] = {}
        for path, s in spec.param_items():
            n = int(np.prod(s.shape)) if s.shape else 1
            arr = np.frombuffer(payload, self.param_dtype, n, off)
            by_path[path] = arr.astype(np.float32).reshape(s.shape)
            off += n * itemsize
        params = rebuild_tree(spec.params, by_path)
        scales, off = _decode_scales_fp32(payload, off, spec)
        return Decoded(params, scales)


class Int8BlockScaleCodec(Codec):
    """Per-block symmetric int8 with one float32 scale per 128 elements.

    Each params leaf is zero-padded to a block multiple, so every block
    sits inside one tensor; the padded leaves are concatenated and
    quantized by ONE kernel launch per message, on the device the
    reconstruction lives on.  Worst-case reconstruction error per block is
    ``amax/254``.
    """

    name = "int8-blockscale"
    block = 128

    def _encode_body(self, upd: ClientUpdate, spec: WireSpec) -> bytes:
        p = [comms_device.as_tensor(leaf)[None]
             for _, leaf in _sent_recon_items(upd, spec)]
        s = ([comms_device.as_tensor(leaf)[None]
              for _, leaf in sorted_items(upd.recon_scales)]
             if spec.scales is not None else [])
        if not p and not s:
            return b""
        return comms_device.int8_rows(p, s, self.block,
                                      batched=False)[0].tobytes()

    def encode_cohort(self, out, spec: WireSpec, *, clients=None):
        return comms_device.int8_encode_cohort(self, out, spec,
                                               clients=clients)

    def _decode_body(self, payload: bytes, spec: WireSpec) -> Decoded:
        off = 0
        by_path: dict[str, np.ndarray] = {}
        for path, s in spec.param_items():
            n = int(np.prod(s.shape)) if s.shape else 1
            padded = n + (-n) % self.block
            nblk = padded // self.block
            q = np.frombuffer(payload, np.int8, padded, off)
            off += padded
            sc = np.frombuffer(payload, "<f4", nblk, off)
            off += nblk * 4
            deq = (q.reshape(nblk, self.block).astype(np.float32)
                   * sc[:, None].astype(np.float32))
            by_path[path] = deq.reshape(-1)[:n].reshape(s.shape)
        params = rebuild_tree(spec.params, by_path)
        scales, off = _decode_scales_fp32(payload, off, spec)
        return Decoded(params, scales)


register_codec("raw-fp32", lambda: RawFloatCodec("raw-fp32", "<f4"))
register_codec("fp16", lambda: RawFloatCodec("fp16", "<f2"))
register_codec("int8-blockscale", Int8BlockScaleCodec)
