"""Typed decode-side failures for the coding stack.

Port of ``repro.coding.errors`` (numpy, unchanged but for imports).

Wire payloads come from the network: a truncated stream, a corrupted
length header, or a shapes tree that does not match the encoder's must
surface as ONE typed error the transport layer can catch — not as a
silent zero-fill (the range decoder's historical `0` fallback byte) and
not as a raw ``IndexError``/``EOFError`` escaping from numpy internals.
"""
from __future__ import annotations


class CorruptPayloadError(ValueError):
    """A payload failed decode-side validation.

    Raised for truncated bitstreams, inconsistent ``cabac_len``/
    ``bypass_len`` headers, range-decoder overrun (reads past the coded
    stream — a well-formed NNC message consumes its cabac section
    *exactly*), decoded values that violate the framing invariants
    (``nnz`` larger than the tensor, run indices out of range, a
    non-zero ``k_rem`` header on a tensor with no >2 magnitudes), and
    shapes trees that provably mismatch the encoded message.

    Subclasses :class:`ValueError` so legacy ``except ValueError``
    call-sites keep working.
    """
