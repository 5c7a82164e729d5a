"""The registered wire codecs of the port.

Port of ``repro.comms.codecs``:

  raw-fp32         little-endian float32 of the reconstruction; lossless.
  fp16             float16 params section (scales stay float32).
  int8-blockscale  per-128-block symmetric int8 through the fused kernel
                   (``kernels/delta_compress.py``; threshold 0, the graph
                   stages already sparsified), then the block scales and a
                   raw float32 scales section.
  golomb           order-k exp-Golomb over zigzagged quantization levels
                   (k per tensor, 4-bit header); lossless on levels.
  nnc-cabac        the paper's stack: DeepCABAC context-coded row-skip
                   flags + zero-runs + gt1/gt2 magnitudes
                   (``coding/nnc.py``); lossless on levels.

Level codecs put the int32 levels on the wire and dequantize on decode;
ternary messages append one float32 magnitude per params tensor after the
level stream.  Every codec carries the schema-v2 frame of
``Codec._frame``.  Payloads are byte-identical to the reference's.
"""
from __future__ import annotations

import copy
import sys

import numpy as np
import torch

from repro_torch.coding import golomb as golomb_lib
from repro_torch.coding import nnc
from repro_torch.coding.bitstream import BitReader
from repro_torch.comms import device as comms_device
from repro_torch.comms.codec import (ClientUpdate, Codec, Decoded, LeafSpec,
                                     WireSpec, check_batch_clients,
                                     decode_bn, rebuild_tree, register_codec,
                                     sorted_items)
from repro_torch.obs.trace import span


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

    Each params leaf's levels are zero-padded to a block multiple, so
    every block sits inside one tensor; ONE kernel launch per message
    (``kernels.delta_compress.int8_encode_leaves``), on the device the
    reconstruction lives on, reads the leaves in place and writes the
    body.  Worst-case reconstruction error per block is ``amax/254``.
    """

    name = "int8-blockscale"
    block = 128
    # the encode launches its kernel on the device's leaves
    host_coder = False

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

    def device_sections(self, payload: bytes, spec: WireSpec,
                        device) -> dict[str, tuple[torch.Tensor,
                                                   torch.Tensor]]:
        """Each params leaf's wire int8 levels ``(n + pad,)`` (padded to
        the block) and float32 block scales ``(ceil(n / block),)``, as
        views into ONE host-to-device copy of ``payload``.  Dequantized
        per block and cut to ``n``, they are :meth:`_decode_body`'s
        params bit for bit; the scales section is not read."""
        if sys.byteorder != "little":
            raise RuntimeError("the wire format is little-endian")
        buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        buf = buf.to(device)
        off = 0
        out = {}
        for path, s in spec.param_items():
            n = int(np.prod(s.shape)) if s.shape else 1
            padded = n + (-n) % self.block
            nblk = padded // self.block
            if off + padded + 4 * nblk > len(payload):
                raise ValueError(f"int8-blockscale payload of "
                                 f"{len(payload)} bytes ends inside leaf "
                                 f"{path!r}")
            q = buf[off:off + padded].view(torch.int8)
            off += padded
            out[path] = (q, buf[off:off + 4 * nblk].view(torch.float32))
            off += 4 * nblk
        return out

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


# ===========================================================================
# level codecs: transmit integer quantization levels, dequantize on decode
# ===========================================================================

def _np_levels(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.int32, copy=False)
    return np.asarray(x, np.int32)


class LevelCodec(Codec):
    """Base for codecs that serialise the int32 level trees.

    Subclasses implement ``_encode_levels``/``_decode_levels`` over the
    ordered ``(path, int32 array)`` sections.  This base adds the ternary
    magnitude tail (one float32 per sent params tensor, after the level
    stream) and dequantizes back to float32 reconstructions with one
    float32 multiply, as the graph does.
    """

    needs = ("levels",)

    def _encode_levels(self, p_items, s_items) -> bytes:
        raise NotImplementedError

    def _decode_levels(self, body: bytes, p_shapes, s_shapes):
        """-> ({path: int32 array}, {path: int32 array})"""
        raise NotImplementedError

    def _level_items(self, upd: ClientUpdate, spec: WireSpec):
        """-> (p_items, s_items): the ordered int32 sections to code."""
        p_items = [(p, _np_levels(leaf))
                   for p, leaf in sorted_items(upd.levels_params)
                   if p in spec.sent_paths]
        s_items = ([] if spec.scales is None else
                   [(p, _np_levels(leaf))
                    for p, leaf in sorted_items(upd.levels_scales)])
        return p_items, s_items

    def _ternary_tail(self, upd: ClientUpdate, spec: WireSpec) -> bytes:
        if not spec.ternary:
            return b""
        return np.array([np.max(np.abs(_np32(leaf)))
                         for _, leaf in _sent_recon_items(upd, spec)],
                        "<f4").tobytes()

    @staticmethod
    def _split_ternary(payload: bytes, spec: WireSpec, n_params: int):
        """-> (level body, per-tensor ternary magnitudes or None)."""
        if not (spec.ternary and n_params):
            return payload, None
        tail = 4 * n_params
        return payload[:-tail], np.frombuffer(payload[-tail:], "<f4")

    def _dequantize(self, p_levels, s_levels, mags, spec: WireSpec,
                    p_shapes, s_shapes) -> Decoded:
        """Decoded level sections -> float32 reconstructions."""
        by_path: dict[str, np.ndarray] = {}
        for i, (path, _) in enumerate(p_shapes):
            lv = p_levels[path].astype(np.float32)
            if spec.ternary:
                by_path[path] = np.float32(mags[i]) * np.sign(lv)
            else:
                by_path[path] = lv * np.float32(spec.param_step(path))
        params = rebuild_tree(spec.params, by_path)
        scales = None
        if spec.scales is not None:
            by_s = {path: s_levels[path].astype(np.float32)
                    * np.float32(spec.fine_step_size)
                    for path, _ in s_shapes}
            scales = rebuild_tree(spec.scales, by_s)
        return Decoded(params, scales)

    @staticmethod
    def _shapes(spec: WireSpec):
        return ([(p, tuple(s.shape)) for p, s in spec.param_items()],
                [(p, tuple(s.shape)) for p, s in spec.scale_items()])

    def _encode_body(self, upd: ClientUpdate, spec: WireSpec) -> bytes:
        p_items, s_items = self._level_items(upd, spec)
        return self._encode_levels(p_items, s_items) + self._ternary_tail(
            upd, spec)

    def _decode_body(self, payload: bytes, spec: WireSpec) -> Decoded:
        p_shapes, s_shapes = self._shapes(spec)
        body, mags = self._split_ternary(payload, spec, len(p_shapes))
        p_levels, s_levels = self._decode_levels(body, p_shapes, s_shapes)
        return self._dequantize(p_levels, s_levels, mags, spec,
                                p_shapes, s_shapes)


class NncCabacCodec(LevelCodec):
    """The paper's DeepCABAC/NNC stack (``repro_torch.coding.nnc``).

    The wire message is ``{"p": <param levels>, "s": <scale levels>}``, the
    reference's ``encode_client_bytes`` message, so payload lengths equal
    its byte accounting.  Batch calls code the cohort against ONE shared
    shapes view, each payload byte-identical to its per-message call.
    """

    name = "nnc-cabac"
    # decode-side engine (coding/nnc.py): the encoded bytes are the same
    # for every engine, so variants interoperate on the wire
    decode_engine = nnc.DEFAULT_ENGINE

    def with_decode_engine(self, engine: str) -> "NncCabacCodec":
        nnc._check_engine(engine)
        if engine == self.decode_engine:
            return self
        dup = copy.copy(self)
        dup.decode_engine = engine
        return dup

    @staticmethod
    def _msg(p_items, s_items) -> dict:
        msg: dict = {"p": dict(p_items)}
        if s_items:
            msg["s"] = dict(s_items)
        return msg

    @staticmethod
    def _msg_shapes(p_shapes, s_shapes) -> dict:
        shapes: dict = {"p": {p: LeafSpec(shape) for p, shape in p_shapes}}
        if s_shapes:
            shapes["s"] = {p: LeafSpec(shape) for p, shape in s_shapes}
        return shapes

    def _encode_levels(self, p_items, s_items) -> bytes:
        return nnc.encode_tree(self._msg(p_items, s_items))

    def _decode_levels(self, body, p_shapes, s_shapes):
        decoded = nnc.decode_tree(body, self._msg_shapes(p_shapes, s_shapes),
                                  engine=self.decode_engine)
        return decoded["p"], decoded.get("s", {})

    def encode_batch(self, upds, spec, *, clients=None):
        check_batch_clients(clients, len(upds), "updates")
        with span("codec.encode_batch", codec=self.name, n=len(upds)):
            pieces = [self._level_items(u, spec) for u in upds]
            bodies = nnc.encode_tree_batch(
                [self._msg(p, s) for p, s in pieces])
            return [self._frame(body + self._ternary_tail(u, spec), u, spec)
                    for body, u in zip(bodies, upds)]

    def encode_cohort(self, out, spec: WireSpec, *, clients=None):
        return comms_device.nnc_encode_cohort(self, out, spec,
                                              clients=clients)

    def decode_batch(self, payloads, spec, *, clients=None):
        check_batch_clients(clients, len(payloads), "payloads")
        if not payloads:
            return []
        with span("codec.decode_batch", codec=self.name, n=len(payloads)):
            p_shapes, s_shapes = self._shapes(spec)
            frames = [self._deframe(p, spec) for p in payloads]
            split = [self._split_ternary(body, spec, len(p_shapes))
                     for body, _ in frames]
            trees = nnc.decode_tree_batch(
                [body for body, _ in split],
                self._msg_shapes(p_shapes, s_shapes),
                engine=self.decode_engine)
            out = []
            for tree, (_, mags), (_, tail) in zip(trees, split, frames):
                dec = self._dequantize(tree["p"], tree.get("s", {}), mags,
                                       spec, p_shapes, s_shapes)
                if spec.version != 1:
                    dec = dec._replace(bn=decode_bn(tail, spec))
                out.append(dec)
            return out

    def payload_sections(self, payload, spec):
        """One nnc payload's anatomy: the 16-byte length header, the CABAC
        and bypass streams, the ternary magnitude tail and the v2 frame
        sections where present.  Sums to ``len(payload)``."""
        sections: dict[str, int] = {}
        body = payload
        bn_tail = 0
        if spec.version != 1:
            sections["frame.header"] = 1
            bn_tail = spec.bn_nbytes
            body = payload[1:len(payload) - bn_tail]
        n_params = len(spec.param_items())
        mag_tail = 4 * n_params if (spec.ternary and n_params) else 0
        if mag_tail:
            body = body[:len(body) - mag_tail]
        sections["nnc.header"] = 16
        sections["nnc.cabac"] = int.from_bytes(body[:8], "big")
        sections["nnc.bypass"] = int.from_bytes(body[8:16], "big")
        if mag_tail:
            sections["ternary.mags"] = mag_tail
        if spec.version != 1:
            sections["frame.bn"] = bn_tail
        return sections


class GolombCodec(LevelCodec):
    """Order-k exp-Golomb over zigzag-mapped levels, one k per tensor.

    Lighter than CABAC (no context modelling, no row-skip flags); zeros
    cost one bit at k=0.  Lossless on levels.
    """

    name = "golomb"
    decode_engine = "vectorized"

    def with_decode_engine(self, engine: str) -> "GolombCodec":
        if engine not in ("vectorized", "speculative"):
            raise ValueError(
                f"codec {self.name!r} has no {engine!r} decode engine")
        if engine == self.decode_engine:
            return self
        dup = copy.copy(self)
        dup.decode_engine = engine
        return dup

    @staticmethod
    def _zigzag(x: np.ndarray) -> np.ndarray:
        x = x.astype(np.int64)
        return (x << 1) ^ (x >> 63)

    @staticmethod
    def _unzigzag(v: np.ndarray) -> np.ndarray:
        return (v >> 1) ^ -(v & 1)

    def _encode_levels(self, p_items, s_items) -> bytes:
        return comms_device.golomb_stream([self._zigzag(leaf.reshape(-1))
                              for _, leaf in list(p_items) + list(s_items)])

    def encode_cohort(self, out, spec: WireSpec, *, clients=None):
        return comms_device.golomb_encode_cohort(self, out, spec,
                                                 clients=clients)

    def _decode_levels(self, body, p_shapes, s_shapes):
        r = BitReader(body)
        egk = (golomb_lib.decode_egk_jump
               if self.decode_engine == "speculative"
               else golomb_lib.decode_egk)

        def section(shapes):
            out = {}
            for path, shape in shapes:
                n = int(np.prod(shape)) if shape else 1
                k = r.get_uint(4)
                vals = egk(r, n, k)
                out[path] = (self._unzigzag(vals).astype(np.int32)
                             .reshape(shape))
            return out

        return section(p_shapes), section(s_shapes)


# ---------------------------------------------------------------- registry

register_codec("raw-fp32", lambda: RawFloatCodec("raw-fp32", "<f4"))
register_codec("fp16", lambda: RawFloatCodec("fp16", "<f2"))
register_codec("int8-blockscale", Int8BlockScaleCodec)
register_codec("golomb", GolombCodec)
register_codec("nnc-cabac", NncCabacCodec)
