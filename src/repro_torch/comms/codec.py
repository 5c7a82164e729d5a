"""Wire codecs: the host-side half of the client<->server pipeline.

Port of ``repro.comms.codec``.  A :class:`Codec` turns one endpoint's
update into a decodable bytes payload and back against a shared
:class:`WireSpec`; ``decode(encode(update))`` needs nothing out of band and
the engine's ``up_bytes`` are ``len(payload)``.  Leaves are sections in
sorted-path order (``repro_torch.tree.sorted_items``).

The base class owns the versioned frame.  Under schema v1 the payload is
the codec body alone; under v2 it is ``[1-byte version][body][BN tail]``,
the tail the client's BN statistics as raw little-endian float32 in
sorted-path order, so every codec carries them without code of its own.
``WireSpec.send_mask`` (partial updates) keeps the leaves marked False off
the wire; they decode to zeros.  Payloads are byte-identical to the
reference's.

Encoders take tensors on any device (or numpy arrays); decoders return
float32 numpy trees.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np

from repro_torch.core import quant as quant_lib
from repro_torch.tree import LeafSpec, map_with_path, sorted_items, tree_map

__all__ = ["ClientUpdate", "Codec", "Decoded", "LeafSpec", "WireSpec",
           "bn_tree", "check_batch_clients", "encode_bn", "frame",
           "get_codec", "make_send_mask", "rebuild_tree", "register_codec",
           "resolve_codec", "shape_template", "sorted_items"]


def shape_template(tree: Any) -> Any:
    return tree_map(lambda x: LeafSpec(tuple(x.shape)), tree)


def rebuild_tree(template: Any, by_path: dict[str, np.ndarray]) -> Any:
    """Reassemble ``template``'s structure from decoded leaves; missing
    paths become float32 zeros."""
    return map_with_path(
        lambda path, spec: (by_path[path] if path in by_path
                            else np.zeros(spec.shape, np.float32)),
        template)


# ---------------------------------------------------------------- wire schema

def _numel(spec: LeafSpec) -> int:
    return int(np.prod(spec.shape)) if spec.shape else 1


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Static schema shared by encoder and decoder.

    ``params``/``scales`` are trees of :class:`LeafSpec` (``scales=None``
    for params-only messages); ``fine_mask`` marks params leaves quantized
    with ``fine_step_size``; ``ternary`` messages carry one float32
    magnitude per params leaf.  ``send_mask`` (a bool tree over params)
    keeps the leaves marked False off the wire.  ``version`` 1 is the
    bare body, 2 adds the one-byte header and the ``bn`` section (a
    :class:`LeafSpec` tree of the BN statistics).
    """
    params: Any
    scales: Any | None = None
    fine_mask: Any | None = None
    step_size: float = quant_lib.STEP_SIZE_UNI
    fine_step_size: float = quant_lib.STEP_SIZE_FINE
    ternary: bool = False
    send_mask: Any | None = None
    bn: Any | None = None
    version: int = 1

    def __post_init__(self):
        if self.version not in (1, 2):
            raise ValueError(f"unknown wire schema version {self.version!r}")
        if self.version == 1 and self.bn is not None:
            raise ValueError("the bn section requires wire schema version=2 "
                             "(v1 payloads are pinned byte-for-byte)")

    @functools.cached_property
    def _param_items(self) -> list[tuple[str, Any]]:
        items = sorted_items(self.params)
        if self.send_mask is None:
            return items
        sent = {p for p, m in sorted_items(self.send_mask) if bool(m)}
        return [(p, s) for p, s in items if p in sent]

    @functools.cached_property
    def _scale_items(self) -> list[tuple[str, Any]]:
        return [] if self.scales is None else sorted_items(self.scales)

    @functools.cached_property
    def _fine_by_path(self) -> dict[str, bool]:
        if self.fine_mask is None:
            return {}
        return {p: bool(m) for p, m in sorted_items(self.fine_mask)}

    @functools.cached_property
    def sent_paths(self) -> frozenset[str]:
        return frozenset(p for p, _ in self._param_items)

    @functools.cached_property
    def _bn_items(self) -> list[tuple[str, Any]]:
        return [] if self.bn is None else sorted_items(self.bn)

    @functools.cached_property
    def bn_nbytes(self) -> int:
        """Length of the (fixed-size) raw-float32 BN tail."""
        return 4 * sum(_numel(s) for _, s in self._bn_items)

    def param_items(self) -> list[tuple[str, Any]]:
        return self._param_items

    def scale_items(self) -> list[tuple[str, Any]]:
        return self._scale_items

    def bn_items(self) -> list[tuple[str, Any]]:
        return self._bn_items

    def param_step(self, path: str) -> float:
        if self._fine_by_path.get(path, False):
            return self.fine_step_size
        return self.step_size


class ClientUpdate(NamedTuple):
    """Encoder-side view of one endpoint's update (level codecs read the
    levels, float codecs the reconstructions)."""
    levels_params: Any
    levels_scales: Any | None
    recon_params: Any
    recon_scales: Any | None
    bn: Any | None = None


class Decoded(NamedTuple):
    """Decoder output: float32 numpy trees in template structure."""
    params: Any
    scales: Any | None
    bn: Any | None = None


# ---------------------------------------------------------------- bn section

def _host32(x: Any) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def encode_bn(bn: Any, spec: WireSpec) -> bytes:
    """Raw little-endian float32 BN tail in sorted-path order (schema v2);
    ``bn`` is a tree of numpy arrays or tensors."""
    if spec.bn is None:
        return b""
    if bn is None:
        raise ValueError("spec declares a bn section but ClientUpdate.bn "
                         "is None")
    by_path = dict(sorted_items(bn))
    return b"".join(
        np.ascontiguousarray(_host32(by_path[p]).astype("<f4")).tobytes()
        for p, _ in spec.bn_items())


def bn_tree(flat: np.ndarray, spec: WireSpec) -> Any:
    """One client's flat float32 BN values, in the tail's order, -> the
    spec's BN tree of numpy arrays."""
    by_path, off = {}, 0
    for path, s in spec.bn_items():
        n = _numel(s)
        by_path[path] = flat[off:off + n].reshape(s.shape)
        off += n
    return rebuild_tree(spec.bn, by_path)


def decode_bn(tail: bytes, spec: WireSpec) -> Any:
    if spec.bn is None:
        return None
    return bn_tree(np.frombuffer(tail, "<f4").astype(np.float32), spec)


def frame(body: bytes, bn_tail: bytes, spec: WireSpec) -> bytes:
    """The payload: the body alone under v1, else ``[version][body][bn]``."""
    if spec.version == 1:
        return body
    return bytes([spec.version]) + body + bn_tail


def make_send_mask(params_template: Any,
                   predicate: Callable[[str, Any], bool]) -> Any:
    """Bool tree over params leaves from a (path, leaf) -> bool predicate."""
    return map_with_path(lambda path, leaf: bool(predicate(path, leaf)),
                         params_template)


# ---------------------------------------------------------------- codec base

def check_batch_clients(clients: Any, n: int, what: str) -> None:
    """One id per message, no duplicates (``None`` = anonymous batch)."""
    if clients is None:
        return
    clients = list(clients)
    if len(clients) != n:
        raise ValueError(f"ragged batch: {len(clients)} client ids for "
                         f"{n} {what}")
    if len(set(clients)) != len(clients):
        dupes = sorted({c for c in clients if clients.count(c) > 1})
        raise ValueError(f"duplicate client ids in batch: {dupes}")


def cohort_size(out: Any) -> int:
    """Client count of a stacked RoundOutput."""
    ls = [leaf for _, leaf in sorted_items(out.recon_delta_params)]
    return int(ls[0].shape[0]) if ls else 0


class Codec:
    """One wire codec: ``encode`` to a payload, ``decode`` back to trees.

    Subclasses set ``name`` and implement ``_encode_body``/``_decode_body``
    over the params and scales sections; the base owns the versioned frame.
    ``encode_batch``/``decode_batch`` give payload i byte-identical to the
    per-message call; ``encode_cohort`` is the device fast path over a
    still-stacked RoundOutput (``None`` = no fast path)."""

    name: str = "?"
    # what encode reads: the reconstructions, or the int32 levels
    needs: tuple[str, ...] = ("recon",)

    def _frame(self, body: bytes, upd: ClientUpdate, spec: WireSpec) -> bytes:
        if spec.version == 1:
            return body
        return frame(body, encode_bn(upd.bn, spec), spec)

    def _deframe(self, payload: bytes, spec: WireSpec) -> tuple[bytes, bytes]:
        """-> (body, bn tail); checks the v2 version header."""
        if spec.version == 1:
            return payload, b""
        if not payload or payload[0] != spec.version:
            got = payload[0] if payload else None
            raise ValueError(f"wire schema mismatch: payload header {got!r}, "
                             f"spec expects version {spec.version}")
        tail = spec.bn_nbytes
        return payload[1:len(payload) - tail], payload[len(payload) - tail:]

    def encode(self, upd: ClientUpdate, spec: WireSpec) -> bytes:
        return self._frame(self._encode_body(upd, spec), upd, spec)

    def decode(self, payload: bytes, spec: WireSpec) -> Decoded:
        body, tail = self._deframe(payload, spec)
        dec = self._decode_body(body, spec)
        if spec.version == 1:
            return dec
        return dec._replace(bn=decode_bn(tail, spec))

    def payload_sections(self, payload: bytes,
                         spec: WireSpec) -> dict[str, int]:
        """Byte count per wire section of one payload; the values sum to
        ``len(payload)``.  The base split knows only the frame."""
        if spec.version == 1:
            return {"body": len(payload)}
        tail = spec.bn_nbytes
        return {"frame.header": 1,
                "body": len(payload) - 1 - tail,
                "frame.bn": tail}

    def encode_batch(self, upds: Sequence[ClientUpdate], spec: WireSpec, *,
                     clients: Sequence[int] | None = None) -> list[bytes]:
        check_batch_clients(clients, len(upds), "updates")
        return [self.encode(u, spec) for u in upds]

    def decode_batch(self, payloads: Sequence[bytes], spec: WireSpec, *,
                     clients: Sequence[int] | None = None) -> list[Decoded]:
        check_batch_clients(clients, len(payloads), "payloads")
        return [self.decode(p, spec) for p in payloads]

    def encode_cohort(self, out: Any, spec: WireSpec, *,
                      clients: Sequence[int] | None = None
                      ) -> list[bytes] | None:
        check_batch_clients(clients, cohort_size(out), "cohort rows")
        return None

    def _encode_body(self, upd: ClientUpdate, spec: WireSpec) -> bytes:
        raise NotImplementedError

    def _decode_body(self, payload: bytes, spec: WireSpec) -> Decoded:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<Codec {self.name}>"


# ---------------------------------------------------------------- registry

_REGISTRY: dict[str, Callable[[], Codec]] = {}
_INSTANCES: dict[str, Codec] = {}


def register_codec(name: str, factory: Callable[[], Codec]) -> None:
    if name in _REGISTRY:
        raise ValueError(f"codec {name!r} already registered")
    _REGISTRY[name] = factory


def get_codec(name: str) -> Codec:
    if name not in _INSTANCES:
        try:
            _INSTANCES[name] = _REGISTRY[name]()
        except KeyError:
            known = ", ".join(sorted(_REGISTRY))
            raise KeyError(f"unknown codec {name!r}; known: {known}") from None
    return _INSTANCES[name]


def resolve_codec(codec: Any, quantize: bool = True) -> Codec:
    """``"auto"``: raw float32 for non-quantizing protocols, else the
    paper's nnc-cabac stack."""
    if isinstance(codec, Codec):
        return codec
    if codec == "auto":
        return get_codec("nnc-cabac" if quantize else "raw-fp32")
    return get_codec(codec)
