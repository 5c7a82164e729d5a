"""Worker side of the uplink's process pool (``fl.rounds.Uplink`` with
``uplink_executor="process"``).

The pool is ``forkserver``-based and preloads ``repro_torch.comms``, so
these functions live here, where a worker has them without importing the
engine.  Each worker gets the codec and the wire spec once, from the pool
initializer; tasks carry ``ClientUpdate``s of numpy arrays and return
numpy, never tensors.
"""
from __future__ import annotations

from repro_torch.comms.codec import (ClientUpdate, Codec, Decoded,
                                     FlatDecoded, WireSpec, flatten_decoded)

_CODEC: Codec | None = None
_SPEC: WireSpec | None = None


def init(codec: Codec, spec: WireSpec) -> None:
    global _CODEC, _SPEC
    _CODEC, _SPEC = codec, spec


def roundtrip(upd: ClientUpdate) -> tuple[int, Decoded]:
    """Encode and decode one update: ``(payload bytes, decoded trees)``."""
    payload = _CODEC.encode(upd, _SPEC)
    return len(payload), _CODEC.decode(payload, _SPEC)


def roundtrip_chunk(chunk: list[ClientUpdate], clients: list[int] | None
                    ) -> list[tuple[int, FlatDecoded]]:
    """Encode and decode a chunk of the cohort through the batch API:
    ``(payload bytes, FlatDecoded)`` pairs, flat float32 arrays that the
    parent rebuilds against its own spec."""
    payloads = _CODEC.encode_batch(chunk, _SPEC, clients=clients)
    decs = _CODEC.decode_batch(payloads, _SPEC, clients=clients)
    return [(len(p), flatten_decoded(d, _SPEC))
            for p, d in zip(payloads, decs)]
