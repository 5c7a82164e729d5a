"""Plain bitstream writer/reader (host-side, numpy-backed).

Port of ``repro.coding.bitstream`` (numpy, unchanged but for imports).

Used for the *bypass* portion of the NNC-style codec: raw bits whose
probability is ~0.5 and which therefore gain nothing from arithmetic coding.
Keeping them out of the arithmetic engine lets us vectorise them with numpy
(run lengths, signs, exp-Golomb remainders), which makes exact byte
measurement affordable inside the FL benchmarks.
"""
from __future__ import annotations

import numpy as np


# per-width MSB-first shift vectors, cached: put_uint runs several times per
# tensor on the encode hot path and np.arange dominated its cost
_SHIFTS: dict[int, np.ndarray] = {}


def _shifts(width: int) -> np.ndarray:
    s = _SHIFTS.get(width)
    if s is None:
        s = _SHIFTS[width] = np.arange(width - 1, -1, -1, dtype=np.int64)
    return s


class BitWriter:
    def __init__(self) -> None:
        self._chunks: list[np.ndarray] = []  # uint8 arrays of 0/1 bits

    def put_bit(self, bit: int) -> None:
        self._chunks.append(np.array([bit & 1], np.uint8))

    def put_bits(self, bits: np.ndarray) -> None:
        """Append a 1-D array of 0/1 values (any int dtype)."""
        if bits.size:
            self._chunks.append(bits.astype(np.uint8) & 1)

    def put_uint(self, value: int, width: int) -> None:
        """Fixed-width big-endian unsigned integer."""
        bits = (value >> _shifts(width)) & 1
        self._chunks.append(bits.astype(np.uint8))

    @property
    def bit_length(self) -> int:
        return int(sum(c.size for c in self._chunks))

    def to_bytes(self) -> bytes:
        if not self._chunks:
            return b""
        bits = np.concatenate(self._chunks)
        return np.packbits(bits).tobytes()


class BitReader:
    def __init__(self, data: bytes) -> None:
        raw = np.frombuffer(data, np.uint8)
        self._bits = np.unpackbits(raw)
        self._pos = 0
        self._ones: np.ndarray | None = None
        self._csum: np.ndarray | None = None
        self._jump: np.ndarray | None = None
        # composed exp-Golomb jump tables, keyed by order k: a multi-section
        # message reuses section 1's doubled table for every later section
        # with the same k (see golomb.decode_egk_jump)
        self.jump_pow: dict[int, tuple[int, np.ndarray]] = {}

    def get_bit(self) -> int:
        b = int(self._bits[self._pos])
        self._pos += 1
        return b

    def get_bits(self, n: int) -> np.ndarray:
        out = self._bits[self._pos:self._pos + n]
        if out.size != n:
            raise EOFError("bitstream exhausted")
        self._pos += n
        return out

    def get_uint(self, width: int) -> int:
        bits = self.get_bits(width)
        return int(bits.dot(1 << _shifts(width)))

    @property
    def bits_remaining(self) -> int:
        return int(self._bits.size - self._pos)

    # -- block access (package-internal) ------------------------------------
    # The vectorized exp-Golomb decoder (golomb.decode_egk)
    # parses many codewords from the underlying bit array in one pass; it
    # reads ``raw_bits``/``tell`` and commits its final cursor via ``seek``.

    @property
    def raw_bits(self) -> np.ndarray:
        return self._bits

    def ones_index(self) -> tuple[np.ndarray, np.ndarray]:
        """(set-bit positions, cumulative-ones prefix) over the WHOLE bit
        array, built once per reader: the bits are immutable, and a
        multi-section message would otherwise pay a full-stream rescan for
        every exp-Golomb section it decodes."""
        if self._ones is None:
            self._ones = np.flatnonzero(self._bits)
            csum = np.zeros(self._bits.size + 1, np.int64)
            np.cumsum(self._bits, out=csum[1:])
            self._csum = csum
        return self._ones, self._csum

    def jump_base(self) -> np.ndarray:
        """k-independent exp-Golomb boundary-jump base, built once per reader.

        ``base[q] = 2 * next_one(q) - q`` for every bit position ``q``: a
        codeword starting at ``q`` ends at ``base[q] + k + 1`` (prefix zeros
        up to the first set bit, then as many value bits again plus ``k``).
        Positions with no remaining set bit — including the two sentinel
        slots ``q in (n, n+1)`` — hold ``n + 2`` so any order-k jump table
        derived from the base clamps them to the ``n + 1`` EOF fixed point.
        Shared by every exp-Golomb section of a message (the base does not
        depend on the section's ``k``)."""
        if self._jump is None:
            n = self._bits.size
            ones, csum = self.ones_index()
            base = np.full(n + 2, n + 2, np.int64)
            if ones.size:
                # positions past the last set bit have no next one — a
                # contiguous dead tail, so no masking is needed up to it
                live = int(ones[-1]) + 1
                t = ones[csum[:live]]
                t += t
                t -= np.arange(live, dtype=np.int64)
                base[:live] = t
            self._jump = base
        return self._jump

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int) -> None:
        if not 0 <= pos <= self._bits.size:
            raise EOFError("bitstream exhausted")
        self._pos = pos
