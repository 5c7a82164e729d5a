"""Wire codecs: the host-side half of the client<->server pipeline.

Port of ``repro.comms.codec`` (wire schema v1).  A :class:`Codec` turns one
endpoint's update into a decodable bytes payload and back against a shared
:class:`WireSpec`; ``decode(encode(update))`` needs nothing out of band and
the engine's ``up_bytes`` are ``len(payload)``.  Under v1 the payload is the
codec body alone, byte-compatible with the reference.  Leaves are sections
in sorted-path order (``repro_torch.tree.sorted_items``).

Encoders take tensors on any device (or numpy arrays); decoders return
float32 numpy trees.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np

from repro_torch.core import quant as quant_lib
from repro_torch.runtime import not_ported
from repro_torch.tree import LeafSpec, map_with_path, sorted_items, tree_map

__all__ = ["ClientUpdate", "Codec", "Decoded", "LeafSpec", "WireSpec",
           "check_batch_clients", "get_codec", "rebuild_tree",
           "register_codec", "resolve_codec", "shape_template",
           "sorted_items"]


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

@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Static schema shared by encoder and decoder (schema v1).

    ``params``/``scales`` are trees of :class:`LeafSpec` (``scales=None``
    for params-only messages); ``fine_mask`` marks params leaves quantized
    with ``fine_step_size``; ``ternary`` messages carry one float32
    magnitude per params leaf.
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
        if self.version != 1 or self.bn is not None:
            raise not_ported("wire schema v2 (BN on the wire)",
                             "wire schema v2, channel, partial updates")
        if self.send_mask is not None:
            raise not_ported("layer-selective send masks",
                             "wire schema v2, channel, partial updates")

    @functools.cached_property
    def _param_items(self) -> list[tuple[str, Any]]:
        return sorted_items(self.params)

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

    def param_items(self) -> list[tuple[str, Any]]:
        return self._param_items

    def scale_items(self) -> list[tuple[str, Any]]:
        return self._scale_items

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

    Subclasses set ``name`` and implement ``_encode_body``/``_decode_body``.
    ``encode_batch``/``decode_batch`` give payload i byte-identical to the
    per-message call; ``encode_cohort`` is the device fast path over a
    still-stacked RoundOutput (``None`` = no fast path)."""

    name: str = "?"
    # what encode reads: the reconstructions, or the int32 levels
    needs: tuple[str, ...] = ("recon",)

    def encode(self, upd: ClientUpdate, spec: WireSpec) -> bytes:
        return self._encode_body(upd, spec)

    def decode(self, payload: bytes, spec: WireSpec) -> Decoded:
        return self._decode_body(payload, spec)

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
