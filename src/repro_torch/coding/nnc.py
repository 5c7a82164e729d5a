"""NNC/DeepCABAC-style lossless coding of quantized differential updates.

Port of ``repro.coding.nnc``: the coder is the reference's numpy code; the
tree walks go over the port's dict trees (``repro_torch.tree``), whose
sorted paths are the reference's, so the bytes are the same.

Bitstream layout (per pytree of int32 quantization levels):

    [u64 cabac_len][u64 bypass_len][cabac stream][bypass stream]

Per tensor (leaves visited in sorted-path order, shapes known to both sides):
  * ndim>=2: one context-coded *row-skip* flag per output row ("skipping
    matrix rows that belong to corresponding sparse filter updates", §3).
  * within kept rows, significant positions are coded as zero-run lengths
    (order-k exp-Golomb, bypass; k chosen per tensor, 4-bit header),
  * signs: bypass bits,
  * magnitudes: context-coded gt1/gt2 flags (DeepCABAC's unary prefix),
    remainder-2 in order-k exp-Golomb bypass bins.

Contexts persist across tensors of one message (adaptive across the update).
The decoder reproduces levels exactly; tests assert bit-exact round-trips.

Two engines produce THE SAME bytes:

  * ``engine="vectorized"`` (default): the two-pass coder — per-tensor bin
    extraction stays array-shaped, pass 1 resolves every bin's probability
    state with the per-context numpy scan (``cabac.context_state_sequence``)
    and pass 2 is the single precomputed-probability range-coder loop
    (``cabac.range_encode_bins``).  Decode walks same-context bin blocks
    through ``Decoder.decode_bits`` and parses exp-Golomb sections with the
    vectorised ``golomb.decode_egk``.
  * ``engine="serial"``: the original one-call-per-bin reference coder.  It
    is the ORACLE the vectorized engine is differentially tested against
    (tests/test_cabac_differential.py) — kept runnable, never dead code.
  * ``engine="speculative"``: the vectorized engine with both speculative
    decode paths enabled — ``cabac.Decoder(speculative=True)`` (MPS-run
    bets verified against the range coder in one compare per bin, serial
    fallback on miss) for the context bins, and the pointer-doubling
    exp-Golomb boundary walk (``golomb.decode_egk_jump``) for large bypass
    sections.  Encoding is byte-identical to ``"vectorized"``; decoding is
    bit-exact but faster on the deeply-adapted contexts and long position
    runs sparse updates produce.

Decoding validates the frame: truncated payloads, inconsistent length
headers, range-decoder overrun, and framing-invariant violations raise
:class:`repro_torch.coding.errors.CorruptPayloadError` instead of zero-filling
or escaping as ``IndexError``.  ``encode_tree_batch``/``decode_tree_batch``
code a whole cohort of messages against ONE shared shapes view (paths
formatted and sorted once) — the host half of the batched uplink API.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.coding import golomb
from repro_torch.coding.bitstream import BitReader, BitWriter
from repro_torch.coding.cabac import (ContextSet, Decoder, Encoder,
                                      encode_context_bins)
from repro_torch.coding.errors import CorruptPayloadError
from repro_torch.obs.trace import span
from repro_torch.tree import LeafSpec, items, rebuild, sorted_items, tree_map

# context ids
CTX_ROW_SKIP = 0
CTX_GT1 = 1
CTX_GT2 = 2
NUM_CTX = 3

DEFAULT_ENGINE = "vectorized"
_ENGINES = ("vectorized", "serial", "speculative")


def _check_engine(engine: str) -> str:
    if engine not in _ENGINES:
        raise ValueError(f"unknown nnc engine {engine!r} "
                         f"(known: {', '.join(_ENGINES)})")
    return engine


def leaves_with_paths(tree: Any):
    """(path, leaf) pairs in sorted-path order — THE canonical wire order.

    The port's ``tree.sorted_items``, whose paths are the reference's
    ``path_str`` on dict trees."""
    return sorted_items(tree)


def _as_rows(arr: np.ndarray) -> np.ndarray:
    if arr.ndim >= 2:
        # explicit row length: reshape(m, -1) is ambiguous for empty tensors
        m = arr.shape[0]
        return arr.reshape(m, arr.size // m if m else 0)
    return arr.reshape(1, -1)


# ===========================================================================
# serial reference coder (the differential oracle)
# ===========================================================================

def encode_tensor(levels: np.ndarray, enc: Encoder, ctx: ContextSet, bypass: BitWriter) -> None:
    rows = _as_rows(np.asarray(levels, np.int64))
    m = rows.shape[0]
    structured = levels.ndim >= 2
    if structured:
        nz_rows = np.any(rows != 0, axis=1)
        for r in range(m):
            enc.encode_bit(ctx, CTX_ROW_SKIP, int(nz_rows[r]))
        kept = rows[nz_rows].reshape(-1)
    else:
        kept = rows.reshape(-1)
    nnz_idx = np.nonzero(kept)[0]
    bypass.put_uint(len(nnz_idx), 32)
    if len(nnz_idx) == 0:
        return
    # positions as zero-run lengths (first gap = absolute index)
    gaps = np.diff(nnz_idx, prepend=-1) - 1
    k_run = golomb.choose_k(gaps)
    bypass.put_uint(k_run, 4)
    golomb.encode_egk(bypass, gaps, k_run)
    vals = kept[nnz_idx]
    mags = np.abs(vals)
    bypass.put_bits((vals < 0).astype(np.uint8))
    # magnitude unary prefix: gt1, gt2 context-coded
    gt1 = mags > 1
    for f in gt1:
        enc.encode_bit(ctx, CTX_GT1, int(f))
    mg1 = mags[gt1]
    gt2 = mg1 > 2
    for f in gt2:
        enc.encode_bit(ctx, CTX_GT2, int(f))
    rem = mg1[gt2] - 3
    # degenerate framing pin: with no >2 magnitudes there are no remainder
    # codewords, but the 4-bit k header is still part of the frame — it is
    # ALWAYS written (as 0) and the decoder requires it to be 0, instead of
    # both sides silently relying on choose_k([]) == 0
    k_rem = golomb.choose_k(rem) if rem.size else 0
    bypass.put_uint(k_rem, 4)
    golomb.encode_egk(bypass, rem, k_rem)


def _decode_tensor_ref(shape: tuple, enc_dec: Decoder, ctx: ContextSet,
                       bypass: BitReader) -> np.ndarray:
    """Reference bin-by-bin decode (differential oracle for the fast path)."""
    ndim = len(shape)
    size = int(np.prod(shape)) if shape else 1
    m = shape[0] if ndim >= 2 else 1
    row_len = size // m if m else 0
    structured = ndim >= 2
    if structured:
        nz_rows = np.array([enc_dec.decode_bit(ctx, CTX_ROW_SKIP)
                            for _ in range(m)], bool).reshape(m)
        kept_len = int(nz_rows.sum()) * row_len
    else:
        nz_rows = np.ones(1, bool)
        kept_len = size
    nnz = bypass.get_uint(32)
    _check_nnz(nnz, kept_len)
    kept = np.zeros(kept_len, np.int64)
    if nnz > 0:
        k_run = bypass.get_uint(4)
        gaps = golomb.decode_egk_ref(bypass, nnz, k_run)
        idx = np.cumsum(gaps + 1) - 1
        _check_positions(idx, kept_len)
        signs = bypass.get_bits(nnz).astype(np.int64)
        mags = np.ones(nnz, np.int64)
        gt1 = np.array([enc_dec.decode_bit(ctx, CTX_GT1)
                        for _ in range(nnz)], bool)
        n1 = int(gt1.sum())
        gt2 = np.array([enc_dec.decode_bit(ctx, CTX_GT2)
                        for _ in range(n1)], bool)
        n2 = int(gt2.sum())
        mg1 = np.full(n1, 2, np.int64)
        k_rem = bypass.get_uint(4)  # always framed when nnz>0
        _check_k_rem(k_rem, n2)
        if n2:
            rem = golomb.decode_egk_ref(bypass, n2, k_rem)
            mg1[gt2] = rem + 3
        mags[gt1] = mg1
        kept[idx] = np.where(signs == 1, -mags, mags)
    return _reassemble(shape, m, row_len, nz_rows, kept)


# ===========================================================================
# vectorized two-pass engine
# ===========================================================================

def _plan_tensor(levels: np.ndarray, bypass: BitWriter,
                 bin_chunks: list[tuple[int, np.ndarray]],
                 nz_rows: np.ndarray | None = None) -> None:
    """Pass-1 bin extraction for one tensor: the vectorized twin of
    :func:`encode_tensor`.  Appends ``(context, bits)`` chunks in coding
    order and writes the (already vectorised) bypass sections.  Identical
    bits to the reference path, but no full-tensor int64 copy and no kept
    copy when every row survives — only the nonzero values are widened.

    ``nz_rows``, when given, is the precomputed row-skip flag vector
    (``rows.any(axis=1)``) — the device uplink computes it on-accelerator
    for the whole cohort in one dispatch and hands it in so pass 1 never
    touches the dense tensor for the row scan.  Flags are exact booleans,
    so the bins (and therefore the bytes) cannot differ.
    """
    rows = _as_rows(np.asarray(levels))
    structured = levels.ndim >= 2
    if structured:
        if nz_rows is None:
            nz_rows = rows.any(axis=1)
        bin_chunks.append((CTX_ROW_SKIP, nz_rows))
        kept = (rows.reshape(-1) if nz_rows.all()
                else rows[nz_rows].reshape(-1))
    else:
        kept = rows.reshape(-1)
    nnz_idx = np.flatnonzero(kept)
    bypass.put_uint(len(nnz_idx), 32)
    if len(nnz_idx) == 0:
        return
    gaps = np.diff(nnz_idx, prepend=-1) - 1
    k_run = golomb.choose_k(gaps)
    bypass.put_uint(k_run, 4)
    golomb.encode_egk(bypass, gaps, k_run)
    vals = kept[nnz_idx].astype(np.int64)
    mags = np.abs(vals)
    bypass.put_bits((vals < 0).astype(np.uint8))
    gt1 = mags > 1
    bin_chunks.append((CTX_GT1, gt1))
    mg1 = mags[gt1]
    gt2 = mg1 > 2
    bin_chunks.append((CTX_GT2, gt2))
    rem = mg1[gt2] - 3
    k_rem = golomb.choose_k(rem) if rem.size else 0   # framing pin (above)
    bypass.put_uint(k_rem, 4)
    golomb.encode_egk(bypass, rem, k_rem)


def _encode_leaves(leaves: Sequence[np.ndarray],
                   row_flags: Sequence[np.ndarray | None] | None = None
                   ) -> bytes:
    """Two-pass encode of ordered level tensors into one NNC message."""
    with span("nnc.encode", leaves=len(leaves)):
        bypass = BitWriter()
        bin_chunks: list[tuple[int, np.ndarray]] = []
        for j, leaf in enumerate(leaves):
            flags = row_flags[j] if row_flags is not None else None
            _plan_tensor(np.asarray(leaf), bypass, bin_chunks, nz_rows=flags)
        total = sum(c.size for _, c in bin_chunks)
        ctx_ids = np.empty(total, np.uint8)
        bits = np.empty(total, np.uint8)
        off = 0
        for c, chunk in bin_chunks:
            n = chunk.size
            ctx_ids[off:off + n] = c
            bits[off:off + n] = chunk
            off += n
        cab = encode_context_bins(ctx_ids, bits, NUM_CTX)
        byp = bypass.to_bytes()
        header = len(cab).to_bytes(8, "big") + len(byp).to_bytes(8, "big")
        return header + cab + byp


def decode_tensor(shape: tuple, enc_dec: Decoder, ctx: ContextSet,
                  bypass: BitReader, jump: bool = False) -> np.ndarray:
    """Fast decode of one tensor: same-context bin blocks decode through
    ``Decoder.decode_bits`` (bit-exactly the reference per-bin walk) and
    the exp-Golomb sections parse vectorised — under ``jump=True`` (the
    speculative engine) via the pointer-doubling boundary walk."""
    egk = golomb.decode_egk_jump if jump else golomb.decode_egk
    ndim = len(shape)
    size = int(np.prod(shape)) if shape else 1
    m = shape[0] if ndim >= 2 else 1
    row_len = size // m if m else 0
    structured = ndim >= 2
    if structured:
        nz_rows = enc_dec.decode_bits(ctx, CTX_ROW_SKIP, m).astype(bool)
        kept_len = int(nz_rows.sum()) * row_len
    else:
        nz_rows = np.ones(1, bool)
        kept_len = size
    nnz = bypass.get_uint(32)
    _check_nnz(nnz, kept_len)
    kept = np.zeros(kept_len, np.int64)
    if nnz > 0:
        k_run = bypass.get_uint(4)
        gaps = egk(bypass, nnz, k_run)
        idx = np.cumsum(gaps + 1) - 1
        _check_positions(idx, kept_len)
        signs = bypass.get_bits(nnz).astype(np.int64)
        mags = np.ones(nnz, np.int64)
        gt1 = enc_dec.decode_bits(ctx, CTX_GT1, nnz).astype(bool)
        n1 = int(gt1.sum())
        gt2 = enc_dec.decode_bits(ctx, CTX_GT2, n1).astype(bool)
        n2 = int(gt2.sum())
        mg1 = np.full(n1, 2, np.int64)
        k_rem = bypass.get_uint(4)  # always framed when nnz>0
        _check_k_rem(k_rem, n2)
        if n2:
            rem = egk(bypass, n2, k_rem)
            mg1[gt2] = rem + 3
        mags[gt1] = mg1
        kept[idx] = np.where(signs == 1, -mags, mags)
    return _reassemble(shape, m, row_len, nz_rows, kept)


# ---------------------------------------------------------------- validation

def _check_nnz(nnz: int, kept_len: int) -> None:
    if nnz > kept_len:
        raise CorruptPayloadError(
            f"decoded nnz={nnz} exceeds the {kept_len} kept positions")


def _check_positions(idx: np.ndarray, kept_len: int) -> None:
    if idx.size and int(idx[-1]) >= kept_len:
        raise CorruptPayloadError(
            f"decoded position {int(idx[-1])} outside the {kept_len} kept "
            "positions")


def _check_k_rem(k_rem: int, n2: int) -> None:
    # the encoder normalises the degenerate n2 == 0 frame to k_rem == 0
    if n2 == 0 and k_rem != 0:
        raise CorruptPayloadError(
            f"non-zero k_rem={k_rem} framed for a tensor with no >2 "
            "magnitudes")


def _reassemble(shape: tuple, m: int, row_len: int, nz_rows: np.ndarray,
                kept: np.ndarray) -> np.ndarray:
    out = np.zeros((m, row_len), np.int32)
    if kept.size:
        out[nz_rows] = kept.reshape(-1, row_len)
    return out.reshape(shape)


# ===========================================================================
# message-level API
# ===========================================================================

def encode_tree(levels_tree: Any, engine: str = DEFAULT_ENGINE) -> bytes:
    """Encode a pytree of int32 level tensors into one NNC message."""
    items = leaves_with_paths(levels_tree)
    if _check_engine(engine) != "serial":   # speculation is decode-side
        return _encode_leaves([np.asarray(l) for _, l in items])
    enc = Encoder()
    ctx = ContextSet(NUM_CTX)
    bypass = BitWriter()
    for _, leaf in items:
        encode_tensor(np.asarray(leaf), enc, ctx, bypass)
    cab = enc.finish()
    byp = bypass.to_bytes()
    header = len(cab).to_bytes(8, "big") + len(byp).to_bytes(8, "big")
    return header + cab + byp


def _split_frame(data: bytes) -> tuple[bytes, bytes]:
    """Validate the 16-byte length header; return (cabac, bypass) streams."""
    if len(data) < 16:
        raise CorruptPayloadError(
            f"message of {len(data)} bytes cannot hold the 16-byte header")
    cab_len = int.from_bytes(data[:8], "big")
    byp_len = int.from_bytes(data[8:16], "big")
    if 16 + cab_len + byp_len != len(data):
        raise CorruptPayloadError(
            f"length header (cabac={cab_len}, bypass={byp_len}) does not "
            f"frame the {len(data)}-byte message")
    return data[16:16 + cab_len], data[16 + cab_len:]


_DECODE_ERRORS = (EOFError, IndexError, ValueError, ZeroDivisionError,
                  OverflowError)


def _decode_sections(data: bytes, path_shapes: list[tuple[str, tuple]],
                     engine: str) -> dict[str, np.ndarray]:
    """Decode one message into {path: int32 array} with frame validation."""
    with span("nnc.decode", nbytes=len(data)):
        return _decode_sections_inner(data, path_shapes, engine)


def _decode_sections_inner(data: bytes, path_shapes: list[tuple[str, tuple]],
                           engine: str) -> dict[str, np.ndarray]:
    cab, byp = _split_frame(data)
    dec = Decoder(cab, strict=True, speculative=(engine == "speculative"))
    ctx = ContextSet(NUM_CTX)
    bypass = BitReader(byp)
    if engine == "serial":
        one = _decode_tensor_ref
    elif engine == "speculative":
        def one(shape, d, c, b):
            return decode_tensor(shape, d, c, b, jump=True)
    else:
        one = decode_tensor
    try:
        decoded = {path: one(shape, dec, ctx, bypass)
                   for path, shape in path_shapes}
    except CorruptPayloadError:
        raise
    except _DECODE_ERRORS as e:
        raise CorruptPayloadError(f"payload failed to decode: {e}") from e
    # a well-formed message is consumed exactly: the cabac stream to the
    # byte, the bypass stream to within its <8 padding bits — leftovers
    # prove the shapes tree does not match the encoder's
    if dec.pos != len(cab):
        raise CorruptPayloadError(
            f"cabac stream length mismatch: consumed {dec.pos} of "
            f"{len(cab)} bytes (shapes tree does not match the message)")
    if bypass.bits_remaining >= 8:
        raise CorruptPayloadError(
            f"{bypass.bits_remaining} unread bypass bits (shapes tree "
            "does not match the message)")
    return decoded


def _shape_items(shapes_tree: Any):
    """(sorted (path, shape) list, rebuild template) for a shapes tree."""
    return ([(p, tuple(s.shape)) for p, s in sorted_items(shapes_tree)],
            shapes_tree)


def _rebuild(decoded: dict[str, np.ndarray], template) -> Any:
    return rebuild(template, decoded)


def decode_tree(data: bytes, shapes_tree: Any,
                engine: str = DEFAULT_ENGINE) -> Any:
    """Decode an NNC message given the pytree of tensor shapes.

    Raises :class:`CorruptPayloadError` for truncated/corrupted payloads
    and for shapes trees that provably mismatch the encoded message.
    """
    _check_engine(engine)
    items, cache = _shape_items(shapes_tree)
    return _rebuild(_decode_sections(data, items, engine), cache)


# ---------------------------------------------------------------- batch API

def encode_tree_batch(trees: Sequence[Any],
                      engine: str = DEFAULT_ENGINE) -> list[bytes]:
    """Encode K clients' level trees against ONE shared shapes view.

    All trees must share the first tree's structure (one cohort, one wire
    schema); paths are formatted and sorted once, so the per-message work
    is only the coding itself.  Returns one payload per tree, each
    byte-identical to ``encode_tree(tree, engine)``.
    """
    _check_engine(engine)
    if not trees:
        return []
    paths0 = [p for p, _ in items(trees[0])]
    order = _batch_leaf_order(trees[0])
    out = []
    for t in trees:
        pairs = items(t)
        paths = [p for p, _ in pairs]
        if paths != paths0:
            raise ValueError(
                "encode_tree_batch needs structurally identical trees; got "
                f"{paths} vs {paths0}")
        ordered = [np.asarray(pairs[i][1]) for i in order]
        if engine != "serial":              # speculation is decode-side
            out.append(_encode_leaves(ordered))
        else:
            enc = Encoder()
            ctx = ContextSet(NUM_CTX)
            bypass = BitWriter()
            for leaf in ordered:
                encode_tensor(leaf, enc, ctx, bypass)
            cab = enc.finish()
            byp = bypass.to_bytes()
            out.append(len(cab).to_bytes(8, "big")
                       + len(byp).to_bytes(8, "big") + cab + byp)
    return out


def encode_leaves_batch(leaf_lists: Sequence[Sequence[np.ndarray]],
                        engine: str = DEFAULT_ENGINE,
                        row_flags: Sequence[Sequence[np.ndarray | None]]
                        | None = None) -> list[bytes]:
    """Encode K clients' PRE-ORDERED leaf lists (sorted-path wire order).

    The pass-1 entry point for the device uplink (``repro_torch.comms.device``):
    the caller already holds the cohort's level tensors as slices of one
    stacked fetch, so there is no pytree to flatten per client.  Each
    ``leaf_lists[k]`` must be the exact sequence ``leaves_with_paths`` would
    produce for client k's tree; ``row_flags[k]``, when given, aligns with
    it (None entries for unstructured tensors) and carries device-computed
    row-skip flags straight into :func:`_plan_tensor`.

    Payload k is byte-identical to ``encode_tree(tree_k, engine)``.
    """
    if _check_engine(engine) != "serial":   # speculation is decode-side
        return [_encode_leaves([np.asarray(l) for l in leaves],
                               row_flags=row_flags[k] if row_flags else None)
                for k, leaves in enumerate(leaf_lists)]
    out = []
    for leaves in leaf_lists:               # oracle path recomputes flags
        enc = Encoder()
        ctx = ContextSet(NUM_CTX)
        bypass = BitWriter()
        for leaf in leaves:
            encode_tensor(np.asarray(leaf), enc, ctx, bypass)
        cab = enc.finish()
        byp = bypass.to_bytes()
        out.append(len(cab).to_bytes(8, "big")
                   + len(byp).to_bytes(8, "big") + cab + byp)
    return out


def _batch_leaf_order(tree: Any) -> list[int]:
    """Leaf indices (in ``tree.items`` order) in sorted-path (wire) order."""
    paths = [p for p, _ in items(tree)]
    return sorted(range(len(paths)), key=lambda i: paths[i])


def decode_tree_batch(payloads: Sequence[bytes], shapes_tree: Any,
                      engine: str = DEFAULT_ENGINE) -> list[Any]:
    """Decode K payloads against ONE shared shapes view (parsed once)."""
    _check_engine(engine)
    items, cache = _shape_items(shapes_tree)
    return [_rebuild(_decode_sections(p, items, engine), cache)
            for p in payloads]


def shapes_of(tree: Any) -> Any:
    """Tree of :class:`LeafSpec` shapes (tuple leaves would walk as trees)."""
    return tree_map(lambda x: LeafSpec(tuple(np.shape(x))), tree)


def encoded_bytes(levels_tree: Any) -> int:
    return len(encode_tree(levels_tree))
