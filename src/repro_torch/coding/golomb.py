"""Exponential-Golomb codes (order-k), vectorised both directions.

Port of ``repro.coding.golomb`` (numpy, unchanged but for imports).

DeepCABAC binarises quantization-level remainders with exp-Golomb codes whose
bins are bypass-coded; STC's position coding is Golomb as well.  Encoding is
fully vectorised (bit matrix assembly in numpy).  :func:`decode_egk` parses
all ``count`` codewords in one pass over the underlying bit array: a cheap
integer walk finds each codeword's boundary (O(1) per codeword via the
cumulative-ones index), then one fancy-indexed gather extracts every value —
this is the server-decode hot path under the vectorized NNC engine.
:func:`decode_egk_jump` replaces that integer walk with a pointer-doubling
orbit over a per-position jump table (``log2(count)`` dense gathers instead
of ``count`` Python iterations) — the bypass half of the ``speculative``
NNC engine.  :func:`decode_egk_ref` keeps the original bit-by-bit walk as
the reference both fast parsers are differentially tested against.
"""
from __future__ import annotations

import numpy as np

from repro_torch.coding.bitstream import BitReader, BitWriter

_MAX_CODE_BITS = 63   # value bits fit int64; longer prefixes prove corruption


def egk_bit_length(values: np.ndarray, k: int) -> np.ndarray:
    """Bits used by order-k exp-Golomb for each unsigned value."""
    v = values.astype(np.int64) + (1 << k)
    nbits = np.floor(np.log2(np.maximum(v, 1))).astype(np.int64) + 1
    # prefix zeros = nbits - k - 1, then nbits bits of value
    return 2 * nbits - k - 1


def choose_k(values: np.ndarray) -> int:
    """Cheap near-optimal order choice: k ~ log2(mean)."""
    if values.size == 0:
        return 0
    mean = float(np.mean(values))
    if mean < 1.0:
        return 0
    return min(15, int(np.floor(np.log2(mean + 1))))


def encode_egk(writer: BitWriter, values: np.ndarray, k: int) -> None:
    """Vectorised order-k exp-Golomb encode of unsigned ints.

    Single-pass bit-matrix assembly: every codeword's value bits are
    extracted with one broadcast shift and scattered with one fancy-indexed
    store (the old per-bit-position loop paid numpy call overhead
    ``nbits.max()`` times over)."""
    if values.size == 0:
        return
    v = values.astype(np.int64) + (1 << k)
    nbits = np.floor(np.log2(v)).astype(np.int64) + 1
    total = 2 * nbits - k - 1  # prefix (nbits-k-1 zeros) + nbits value bits
    offsets = np.cumsum(total) - total
    out = np.zeros(int(total.sum()), np.uint8)
    vstart = offsets + total - nbits   # value bits end each codeword
    # group codewords by bit length: every group shares one rectangular
    # (count, nb) layout, so the whole section assembles with ~log(vmax)
    # dense fancy stores and no ragged masking temporaries
    for nb in np.unique(nbits).tolist():
        idx = np.flatnonzero(nbits == nb)
        cols = np.arange(nb)
        bits_mat = (v[idx, None] >> (nb - 1 - cols)[None, :]) & 1
        out[vstart[idx, None] + cols[None, :]] = bits_mat
    writer.put_bits(out)


def decode_egk_ref(reader: BitReader, count: int, k: int) -> np.ndarray:
    """Reference bit-by-bit decode (the fast parser's differential oracle)."""
    out = np.empty(count, np.int64)
    for i in range(count):
        zeros = 0
        while reader.get_bit() == 0:
            zeros += 1
        nbits = zeros + k + 1
        rest = 0
        for _ in range(nbits - 1):
            rest = (rest << 1) | reader.get_bit()
        v = (1 << (nbits - 1)) | rest
        out[i] = v - (1 << k)
    return out


def decode_egk(reader: BitReader, count: int, k: int) -> np.ndarray:
    """Vectorised order-k exp-Golomb decode of ``count`` values.

    Phase 1 walks codeword boundaries with plain ints: the prefix of
    codeword *i* ends at the first set bit at or after its start, found in
    O(1) from the cumulative-ones index (value bits may contain ones, so a
    simple "next one" pointer would not do).  Phase 2 gathers all value
    bits in one fancy-indexed matrix multiply.  Bit-exact with
    :func:`decode_egk_ref`; raises ``EOFError`` on a truncated stream and
    ``ValueError`` on codewords too long to be well-formed.
    """
    if count == 0:
        return np.empty(0, np.int64)
    bits = reader.raw_bits
    nbits_total = bits.size
    # whole-stream set-bit index, built once per reader (immutable bits):
    # csum[i] = ones in bits[:i] -> index into `ones` of the first set bit
    # at position >= i
    ones, csum = reader.ones_index()
    starts = np.empty(count, np.int64)
    nbits = np.empty(count, np.int64)
    s = reader.tell()
    try:
        for i in range(count):
            z = ones[csum[s]]           # first 1 at/after s ends the prefix
            nb = (z - s) + k + 1
            starts[i] = z
            nbits[i] = nb
            s = z + nb
    except IndexError:
        raise EOFError("bitstream exhausted") from None
    if s > nbits_total:
        raise EOFError("bitstream exhausted")
    v = _extract_values(bits, starts, nbits)
    reader.seek(s)
    return v - (1 << k)


def _extract_values(bits: np.ndarray, starts: np.ndarray,
                    nbits: np.ndarray) -> np.ndarray:
    """Phase 2: gather every codeword's MSB-first value bits in one
    fancy-indexed matrix multiply (``starts`` point at each codeword's
    first set bit).  Raises ``ValueError`` on codewords too long to be
    well-formed."""
    if nbits.size == 0:
        return np.zeros(0, np.int64)
    maxnb = int(nbits.max())
    if maxnb > _MAX_CODE_BITS:
        raise ValueError(f"exp-Golomb codeword of {maxnb} bits (corrupt)")
    # right-align every codeword's value bits so the bit weights are the
    # same for every row and the ragged sum collapses into one matvec
    cols = np.arange(maxnb)
    idx = (starts + nbits)[:, None] + (cols - maxnb)[None, :]
    valid = cols[None, :] >= (maxnb - nbits[:, None])
    mat = bits[np.clip(idx, 0, bits.size - 1)] & valid
    return mat.astype(np.int64) @ (np.int64(1) << (maxnb - 1 - cols))


# below this count the jump decoder falls back to the sequential boundary
# walk: the table build + doubling rounds are O(stream) while the walk is
# O(count), so short sections (remainder tails, tiny tensors) lose
_JUMP_MIN = 512

# doubling the jump table costs one full-stream gather per round; past this
# jump width it is cheaper to extend the orbit in fixed-width chunks
_JUMP_CAP = 2048


def decode_egk_jump(reader: BitReader, count: int, k: int) -> np.ndarray:
    """Order-k exp-Golomb decode with a speculative parallel boundary walk.

    The sequential phase-1 recurrence ``s' = 2 * next_one(s) - s + k + 1``
    is a pointer chase through a table that exists for EVERY bit position:
    ``f = clip(reader.jump_base() + k + 1, n + 1)`` (the ``n + 1`` slot is
    an EOF fixed point).  Starts then enumerate by pointer doubling —
    ``f[f]`` jumps two codewords, ``f[f][f[f]]`` four — so the orbit of
    ``count`` boundaries resolves in ``log2(count)`` dense gathers instead
    of ``count`` Python iterations.  Each codeword's first-set-bit position
    falls out of consecutive starts (``z = (s + s' - k - 1) / 2``), so no
    per-codeword index walk remains.  Bit-exact with :func:`decode_egk`
    (same values, same cursor, same EOFError/ValueError surface); used by
    the ``speculative`` NNC engine on large sections.
    """
    if count < _JUMP_MIN:
        return decode_egk(reader, count, k)
    bits = reader.raw_bits
    n = bits.size
    base = reader.jump_base()
    cached = reader.jump_pow.get(k)
    if cached is not None:
        # reuse an earlier section's composed table: seed the first `jump`
        # starts with a scalar walk over the base, then extend jump-wide
        jump, f = cached
        s = reader.tell()
        seed = np.empty(min(jump, count + 1), np.int64)
        for i in range(seed.size):
            seed[i] = s
            s = int(base[s]) + (k + 1)
            if s > n:
                s = n + 1
        starts = seed
    else:
        f = base + (k + 1)
        np.minimum(f, n + 1, out=f)
        starts = np.array([reader.tell()], np.int64)
        jump = 1
    while starts.size < count + 1:
        ext = f[starts[-jump:]]
        need = count + 1 - starts.size
        starts = np.concatenate([starts, ext[:need] if ext.size > need
                                 else ext])
        if starts.size < count + 1 and jump < _JUMP_CAP:
            f = f[f]
            jump <<= 1
    if cached is None and jump > 1:
        reader.jump_pow[k] = (jump, f)
    s = int(starts[-1])
    if s > n:
        raise EOFError("bitstream exhausted")
    # codeword i's first set bit: s_{i+1} = 2 z_i - s_i + k + 1, exactly
    zs = (starts[:-1] + starts[1:] - (k + 1)) >> 1
    nbits = starts[1:] - zs
    v = _extract_values(bits, zs, nbits)
    reader.seek(s)
    return v - (1 << k)
