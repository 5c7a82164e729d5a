"""Adaptive binary arithmetic coder (LZMA-style binary range coder).

Port of ``repro.coding.cabac`` (numpy, unchanged but for imports).

This is the "CABAC" engine of our DeepCABAC-like NNC codec: context-adaptive
probabilities (11-bit, shift-adapted) with carry-correct byte renormalisation.
Bypass (p=0.5) bins live in a separate raw bitstream (see bitstream.py) so
they can be vectorised; only context-coded bins pass through this engine.

Two engines share the bit-exact stream format:

* the **serial reference** (:class:`Encoder`/:class:`Decoder.decode_bit`):
  one Python call per bin — the oracle every fast path is differentially
  tested against (tests/test_cabac_differential.py), never dead code;
* the **two-pass vectorized encoder** (:func:`encode_context_bins`): pass 1
  derives every bin's probability state with numpy — the 11-bit
  shift-adaptation recurrence depends only on each context's own bin
  subsequence, so it is a per-context scan over precomputed transition
  orbits (:func:`context_state_sequence`), vectorised over runs of equal
  bits.  Pass 2 (:func:`range_encode_bins`) is the only remaining loop: the
  carry-correct renormalisation with the probability already in hand —
  byte-for-byte identical to the reference encoder.

The decoder cannot precompute states (each decoded bit feeds the next
state), but :meth:`Decoder.decode_bits` decodes a whole same-context block
per call with local-variable state — bit-exactly the repeated
``decode_bit`` — which is what makes the fast NNC decode path
(`repro_torch.coding.nnc`) competitive with the vectorized encoder.

A third path, **speculative multi-symbol decode**
(``Decoder(..., speculative=True)``), goes beyond the per-bin walk by
betting on the most-probable symbol (MPS).  While a context sits in
MPS=0 territory (``p >= 1024``), a run of zero bits has three properties
the serial loop pays for but never uses:

* ``code`` is untouched (bit 0 only shrinks ``range`` to ``bound``);
* the bounds are strictly decreasing, so "this bin is 0" is just
  ``bound > code``;
* the probability states walk the precomputed bit-0 transition orbit
  (:func:`_orbit_tables`) — no per-bin adaptation arithmetic.

So the speculative hit loop verifies one bin with a single multiply and a
single compare against the constant ``lim = max(code + 1, TOP)``: a bound
above ``lim`` simultaneously proves the bit is 0 AND that no
renormalisation is due.  On a miss (the compare fails: either the bit is
really 1, or a renorm must feed bytes first) it falls back to the exact
serial step for that one bin, then re-speculates.  Every committed bit
replays the reference update on identical state, so the stream walk —
probabilities, range, code, byte positions, strict-mode overrun errors —
is bit-exactly :meth:`Decoder.decode_bits` (differentially fuzzed in
tests/test_cabac_differential.py, forced misses included).
"""
from __future__ import annotations

import numpy as np

from repro_torch.coding.errors import CorruptPayloadError
from repro_torch.obs.trace import span

_TOP = 1 << 24
_BOT = 1 << 11  # probability scale (2048)
_INIT_P = _BOT // 2
_ADAPT_SHIFT = 5
# speculation engages when P(bit=0) >= _SPEC_MIN/2048: the expected MPS
# run (p/(2048-p) ~ 16 bins) then amortises the per-attempt setup; below
# it the serial step is cheaper than a likely-failed bet.  Tuned on the
# sparse regime the engine exists for (p1 <= ~2% wins up to ~2.5x; the
# moderate-density band pays ~10-15% — which is why "speculative" is an
# opt-in engine, not the default)
_SPEC_MIN = 1927


class ContextSet:
    """A bank of adaptive probability states (probability of bit == 0)."""

    def __init__(self, n: int) -> None:
        self.p = np.full(n, _INIT_P, np.int32)

    def reset(self) -> None:
        self.p[:] = _INIT_P


class Encoder:
    def __init__(self) -> None:
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self) -> None:
        if self.low < 0xFF000000 or self.low >= 0x100000000:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            pending = (0xFF + carry) & 0xFF
            for _ in range(self.cache_size - 1):
                self.out.append(pending)
            self.cache_size = 0
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode_bit(self, ctxs: ContextSet, idx: int, bit: int) -> None:
        p = int(ctxs.p[idx])
        bound = (self.range >> 11) * p
        if bit == 0:
            self.range = bound
            ctxs.p[idx] = p + ((_BOT - p) >> _ADAPT_SHIFT)
        else:
            self.low += bound
            self.range -= bound
            ctxs.p[idx] = p - (p >> _ADAPT_SHIFT)
        while self.range < _TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self._shift_low()

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class Decoder:
    """Range decoder.  ``strict=True`` raises :class:`CorruptPayloadError`
    instead of zero-filling when the coded stream is exhausted: a
    well-formed stream is consumed *exactly* (the encoder's 5-shift flush
    emits every byte the decoder's init+renormalisations will read), so any
    overrun proves truncation or a corrupted length header."""

    def __init__(self, data: bytes, strict: bool = False,
                 speculative: bool = False) -> None:
        self.data = data
        self.pos = 0
        self.strict = strict
        self.speculative = speculative
        self.range = 0xFFFFFFFF
        self.code = 0
        for _ in range(5):
            self.code = ((self.code << 8) | self._next_byte()) & 0xFFFFFFFFFF
        self.code &= 0xFFFFFFFF

    def _next_byte(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
        elif self.strict:
            raise CorruptPayloadError(
                f"cabac stream exhausted at byte {self.pos} "
                f"(stream is {len(self.data)} bytes)")
        else:
            b = 0
        self.pos += 1
        return b

    def decode_bit(self, ctxs: ContextSet, idx: int) -> int:
        p = int(ctxs.p[idx])
        bound = (self.range >> 11) * p
        if self.code < bound:
            bit = 0
            self.range = bound
            ctxs.p[idx] = p + ((_BOT - p) >> _ADAPT_SHIFT)
        else:
            bit = 1
            self.code -= bound
            self.range -= bound
            ctxs.p[idx] = p - (p >> _ADAPT_SHIFT)
        while self.range < _TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | self._next_byte()) & 0xFFFFFFFF
        return bit

    def decode_bits(self, ctxs: ContextSet, idx: int, n: int) -> np.ndarray:
        """Decode ``n`` consecutive bins of ONE context in a tight loop.

        Bit-exactly ``[self.decode_bit(ctxs, idx) for _ in range(n)]`` —
        the probability state, range and code walk the identical sequence —
        but with all coder state in locals, so the per-bin cost is a
        fraction of the method-dispatch + numpy-scalar-indexing reference
        path.  Returns a uint8 array of the decoded bits.
        """
        if n <= 0:
            return np.zeros(0, np.uint8)
        if self.speculative:
            return self._decode_bits_spec(ctxs, idx, n)
        out = bytearray(n)
        p = int(ctxs.p[idx])
        rng = self.range
        code = self.code
        data = self.data
        pos = self.pos
        dlen = len(data)
        strict = self.strict
        top, m32, bot = _TOP, 0xFFFFFFFF, _BOT
        for i in range(n):
            bound = (rng >> 11) * p
            if code < bound:
                rng = bound
                p += (bot - p) >> 5
            else:
                out[i] = 1
                code -= bound
                rng -= bound
                p -= p >> 5
            while rng < top:
                rng = (rng << 8) & m32
                if pos < dlen:
                    b = data[pos]
                elif strict:
                    self.pos = pos
                    raise CorruptPayloadError(
                        f"cabac stream exhausted at byte {pos} "
                        f"(stream is {dlen} bytes)")
                else:
                    b = 0
                pos += 1
                code = ((code << 8) | b) & m32
        ctxs.p[idx] = p
        self.range = rng
        self.code = code
        self.pos = pos
        return np.frombuffer(bytes(out), np.uint8)

    def _decode_bits_spec(self, ctxs: ContextSet, idx: int,
                          n: int) -> np.ndarray:
        """Speculative multi-symbol decode of ``n`` same-context bins.

        Speculates that upcoming bins are the most-probable symbol.  For
        MPS=0 (``p >= 1024``) a hit costs one multiply and one compare:
        bit 0 leaves ``code`` and the byte stream untouched, so
        ``bound > max(code, TOP - 1)`` verifies the bit AND rules out a
        renorm in one go, with the probability trajectory read off the
        precomputed bit-0 orbit (:func:`_orbit_tables`) instead of being
        recomputed per bin.  Deeply-adapted contexts (sparse NNC streams
        drive ``p`` to its ~2017 fixed point) renorm only every ~360 bins,
        so almost every bin takes the two-op path.  A failed compare — a
        true 1-bit or a pending renorm — resolves the boundary bin with
        the exact serial step before re-speculating, and states below
        ``_SPEC_MIN`` run the reference per-bin walk until they adapt
        back into speculation range.

        Bit-exactly :meth:`decode_bits` on every stream (see the module
        docstring for the commit/verify argument).
        """
        out = bytearray(n)
        p = int(ctxs.p[idx])
        rng = self.range
        code = self.code
        data = self.data
        pos = self.pos
        dlen = len(data)
        strict = self.strict
        top, m32, bot = _TOP, 0xFFFFFFFF, _BOT
        spec = _spec_rows()
        i = 0
        while i < n:
            if p < _SPEC_MIN:
                # -- serial regime: the reference per-bin walk (identical
                # loop shape and cost to :meth:`decode_bits`, plus one
                # threshold compare) until the state crosses into
                # speculation range
                ran_out = True
                for j in range(i, n):
                    bound = (rng >> 11) * p
                    if code < bound:
                        rng = bound
                        p += (bot - p) >> 5
                    else:
                        out[j] = 1
                        code -= bound
                        rng -= bound
                        p -= p >> 5
                    while rng < top:
                        rng = (rng << 8) & m32
                        if pos < dlen:
                            b = data[pos]
                        elif strict:
                            self.pos = pos
                            raise CorruptPayloadError(
                                f"cabac stream exhausted at byte {pos} "
                                f"(stream is {dlen} bytes)")
                        else:
                            b = 0
                        pos += 1
                        code = ((code << 8) | b) & m32
                    if p >= _SPEC_MIN:
                        i = j + 1
                        ran_out = False
                        break
                if ran_out:
                    i = n
                    break
                continue
            # -- speculate: the next bins are all 0 (the MPS).  Bounds
            # decrease strictly within a 0-run, so each unrolled block is
            # verified by ONE compare on its LAST bound; a clearing block
            # simultaneously proves every bit is 0 and that no renorm was
            # due (code and the byte stream are untouched).
            row, nfix = spec[p]
            lim = code + 1 if code >= top else top
            t = 0
            tmax = n - i
            # orbit phase, 4-wide: p still adapting along the bit-0 orbit
            # (the padding entries ARE the fixed point, so every row[t]
            # read is the exact per-bin state)
            stop = tmax - 4 if tmax - 4 < nfix else nfix
            while t <= stop:
                a = (rng >> 11) * row[t]
                a = (a >> 11) * row[t + 1]
                a = (a >> 11) * row[t + 2]
                a = (a >> 11) * row[t + 3]
                if a < lim:
                    break
                rng = a
                t += 4
            # single-step the orbit remainder — and, after a failed block,
            # walk to the exact boundary bin inside THIS attempt (the
            # failing block proves only that one of its four bins misses)
            bound1 = tmax if tmax < nfix + 4 else nfix + 4
            run = True
            while t < bound1:
                nxt = (rng >> 11) * row[t]
                if nxt < lim:
                    run = False
                    break
                rng = nxt
                t += 1
            if run and t < tmax:
                # fixed-point phase: constant probability, pure range
                # decay at ~2 interpreter ops per bin
                fp = row[nfix]
                while t + 8 <= tmax:
                    a = ((rng >> 11) * fp >> 11) * fp
                    a = ((a >> 11) * fp >> 11) * fp
                    a = ((a >> 11) * fp >> 11) * fp
                    a = ((a >> 11) * fp >> 11) * fp
                    if a < lim:
                        break
                    rng = a
                    t += 8
                while t < tmax:
                    nxt = (rng >> 11) * fp
                    if nxt < lim:
                        break
                    rng = nxt
                    t += 1
            if t:
                i += t
                p = row[t] if t < nfix else row[nfix]
                if i == n:
                    break
            # -- exact serial step for the boundary bin: a true 1-bit, or
            # a 0-bit whose commit owes a renormalisation ------------------
            bound = (rng >> 11) * p
            if code < bound:
                rng = bound
                p += (bot - p) >> 5
            else:
                out[i] = 1
                code -= bound
                rng -= bound
                p -= p >> 5
            while rng < top:
                rng = (rng << 8) & m32
                if pos < dlen:
                    b = data[pos]
                elif strict:
                    self.pos = pos
                    raise CorruptPayloadError(
                        f"cabac stream exhausted at byte {pos} "
                        f"(stream is {dlen} bytes)")
                else:
                    b = 0
                pos += 1
                code = ((code << 8) | b) & m32
            i += 1
        ctxs.p[idx] = p
        self.range = rng
        self.code = code
        self.pos = pos
        return np.frombuffer(bytes(out), np.uint8)


# ===========================================================================
# two-pass vectorized encoder
# ===========================================================================
#
# The adaptation recurrence  p' = p + ((2048-p)>>5)   (bit 0)
#                            p' = p - (p>>5)          (bit 1)
# touches only the 11-bit state of the bin's OWN context, so the state every
# bin sees is a function of that context's bin subsequence alone — pass 1
# computes it without touching the range coder.  Within a run of equal bits
# the states walk a fixed orbit of the per-bit transition map; orbits reach
# their fixed point in <~150 steps, so one precomputed (2, 2048, cap+1)
# table turns the whole scan into a run-length pass: one table lookup per
# run for the carry-over state, one fancy-indexed gather for every bin.

_ORBIT: np.ndarray | None = None     # (2, _BOT, cap+1) int32
_ORBIT_CAP: int = 0
_ORBIT_END: list | None = None       # nested-list view for the scalar walk


def _orbit_tables() -> tuple[np.ndarray, int]:
    global _ORBIT, _ORBIT_CAP
    if _ORBIT is None:
        p = np.arange(_BOT, dtype=np.int32)
        nxt = np.stack([p + ((_BOT - p) >> _ADAPT_SHIFT),
                        p - (p >> _ADAPT_SHIFT)])
        cols = [np.stack([p, p])]
        while True:
            cur = cols[-1]
            step = np.stack([nxt[0][cur[0]], nxt[1][cur[1]]])
            if np.array_equal(step, cur):   # every orbit at its fixed point
                break
            cols.append(step)
        _ORBIT = np.ascontiguousarray(np.stack(cols, axis=-1))
        _ORBIT_CAP = len(cols) - 1
    return _ORBIT, _ORBIT_CAP


def _orbit_end() -> list:
    """``orbit`` as nested Python lists: the run-to-run carry walk does one
    scalar lookup per run, and list indexing is ~5x a numpy scalar index."""
    global _ORBIT_END
    if _ORBIT_END is None:
        _ORBIT_END = _orbit_tables()[0].tolist()
    return _ORBIT_END


_SPEC: list | None = None


def _spec_rows() -> list:
    """The speculation table: for every probability state ``p``, the exact
    per-bin state trajectory of an all-zeros (MPS=0) run, trimmed at ITS
    OWN fixed point rather than the global orbit cap.

    Entry ``p`` is ``(row, nfix)``: ``row[t]`` is the state bin ``t`` of
    the speculative run is coded with (the bit-0 adaptation is strictly
    increasing until it pins at 2017, so the first fixed-point index is
    the trim point), padded with 7 extra fixed-point copies so the
    4-wide unrolled verify loop can read past ``nfix`` without bounds
    checks — the padding values ARE the true states there.  Built lazily
    from :func:`_orbit_tables` once per process.
    """
    global _SPEC
    if _SPEC is None:
        rows = _orbit_tables()[0][0].tolist()
        spec = []
        for r in rows:
            fp = r[-1]
            nfix = r.index(fp)
            spec.append((r[:nfix + 1] + [fp] * 7, nfix))
        _SPEC = spec
    return _SPEC


def context_state_sequence(bits: np.ndarray) -> np.ndarray:
    """Pass 1 for ONE context: the probability state each bin is coded with.

    ``bits`` is the context's bin subsequence (in coding order);  returns an
    int32 array of the same length holding the state *before* each bin —
    exactly the ``p`` the serial ``encode_bit``/``decode_bit`` would read.
    Vectorised over runs of equal bits via the precomputed transition
    orbits; the only Python loop is one table lookup per run.
    """
    bits = np.asarray(bits, np.uint8)
    n = bits.size
    if n == 0:
        return np.zeros(0, np.int32)
    orbit, cap = _orbit_tables()
    boundaries = np.flatnonzero(np.diff(bits)) + 1
    starts = np.concatenate(([0], boundaries))
    lens = np.diff(np.concatenate((starts, [n])))
    run_bits = bits[starts].astype(np.intp)
    # carry the state across runs: one orbit-endpoint lookup per run
    end = _orbit_end()
    p = _INIT_P
    run_p = []
    for b, h in zip(run_bits.tolist(), np.minimum(lens, cap).tolist()):
        run_p.append(p)
        p = end[b][p][h]
    run_p = np.asarray(run_p, np.intp)
    # gather every bin's state from its run's orbit
    t = np.arange(n) - np.repeat(starts, lens)
    np.minimum(t, cap, out=t)        # beyond cap the orbit sits at its
    return orbit[np.repeat(run_bits, lens),   # fixed point (= column cap)
                 np.repeat(run_p, lens), t]


def range_encode_bins(bits: np.ndarray, probs: np.ndarray) -> bytes:
    """Pass 2: carry-correct range coding with precomputed probabilities.

    Byte-for-byte identical to feeding the (bit, state) pairs through the
    reference :class:`Encoder` — same bound arithmetic, same
    renormalisation, same 5-shift flush — but the loop body is only the
    range/low bookkeeping (the context model was fully resolved in pass 1).
    """
    low = 0
    rng = 0xFFFFFFFF
    cache = 0
    cache_size = 1
    out = bytearray()
    append = out.append
    extend = out.extend
    top, m32, hi, of = _TOP, 0xFFFFFFFF, 0xFF000000, 0x100000000
    # one packed (state << 1 | bit) int per bin: a single tolist() and a
    # single loop variable measurably beat a zip of two converted arrays
    packed = ((probs.astype(np.int64) << 1)
              | np.asarray(bits, np.int64)).tolist()
    for v in packed:
        bound = (rng >> 11) * (v >> 1)
        if v & 1:
            low += bound
            rng -= bound
        else:
            rng = bound
        while rng < top:
            rng = (rng << 8) & m32
            if low < hi or low >= of:
                carry = low >> 32
                append((cache + carry) & 0xFF)
                if cache_size > 1:
                    extend(((0xFF + carry) & 0xFF).to_bytes(1, "big")
                           * (cache_size - 1))
                cache_size = 0
                cache = (low >> 24) & 0xFF
            cache_size += 1
            low = (low << 8) & m32
    for _ in range(5):          # flush (identical to Encoder.finish)
        if low < hi or low >= of:
            carry = low >> 32
            append((cache + carry) & 0xFF)
            if cache_size > 1:
                extend(((0xFF + carry) & 0xFF).to_bytes(1, "big")
                       * (cache_size - 1))
            cache_size = 0
            cache = (low >> 24) & 0xFF
        cache_size += 1
        low = (low << 8) & m32
    return bytes(out)


def encode_context_bins(ctx_ids: np.ndarray, bits: np.ndarray,
                        num_ctx: int) -> bytes:
    """Two-pass vectorized encode of an entire context-coded bin stream.

    ``ctx_ids``/``bits`` describe every bin of one message in coding order.
    Contexts are independent in pass 1 (each state depends only on its own
    subsequence), so the scan runs per context and the states scatter back
    into stream order for the single pass-2 loop.
    """
    ctx_ids = np.asarray(ctx_ids, np.uint8)
    bits = np.asarray(bits, np.uint8)
    if ctx_ids.shape != bits.shape:
        raise ValueError("ctx_ids and bits must be parallel arrays")
    probs = np.empty(bits.size, np.int32)
    with span("cabac.pass1.state_scan", bins=int(bits.size)):
        for c in range(num_ctx):
            sel = ctx_ids == c
            if sel.any():
                probs[sel] = context_state_sequence(bits[sel])
    with span("cabac.pass2.range_encode", bins=int(bits.size)):
        return range_encode_bins(bits, probs)
