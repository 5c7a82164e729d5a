"""GQA attention: chunked online-softmax forward (train and prefill) and a
cached one-token decode over a ring-buffer KV cache.

Port of ``repro.models.attention``, per-shard code (see
``common.ShardCtx``):

* train and prefill: Megatron sequence parallelism.  The seq-sharded
  residual stream is gathered, q, k, v are column-parallel over the
  shard's heads, the output projection is row-parallel and its partial
  sums are reduce-scattered back to the shard's sequence slice.  Where
  the kv heads do not divide over tp, k and v are computed whole on every
  shard and each shard attends with the kv groups its q heads belong to
  (whole groups, or one group that several shards share).
* decode: the KV cache is laid out (kv groups x sequence parts) over the
  tp axis.  Each shard owns one kv-head group and 1/r of the ring, writes
  a token only where it owns the slot, attends with every q head of its
  group over its part, and the r partial results of a group are combined
  with a log-sum-exp reduce within the group (the flash-decoding
  analogue); each shard then keeps its own q heads for the row-parallel
  output projection and its psum.

Masking uses the finite ``NEG_INF = -1e30``, as the reference does: a kv
chunk that masks a whole query row gives that row ``p = exp(0) = 1`` on
every entry, and the next chunk's ``corr = exp(m - m_new)`` cancels it;
with ``-inf`` the same row would be NaN.  A kv chunk that masks every
(query, key) pair of a block leaves the running state as it found it, or
is wiped exactly by the next chunk's ``corr = 0``, so such blocks are
skipped: the result is the same, bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common
from repro_torch.models.common import ShardCtx, softcap

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnParamsSpec:
    """Static split of heads across the tp axis."""
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_model: int
    tp: int = 1
    replicated: bool = False

    @property
    def q_local(self) -> int:
        return self.n_heads if self.replicated else self.n_heads // self.tp

    @property
    def kv_sharded(self) -> bool:
        return (not self.replicated) and self.n_kv_heads % self.tp == 0

    @property
    def kv_local(self) -> int:
        return self.n_kv_heads // self.tp if self.kv_sharded else self.n_kv_heads

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    # ---- decode plan: kv_groups x seq_parts == tp --------------------
    @property
    def decode_kv_shards(self) -> int:
        if self.replicated:
            return 1
        return min(self.n_kv_heads, self.tp)

    @property
    def decode_seq_parts(self) -> int:
        return max(1, self.tp // self.decode_kv_shards)

    @property
    def decode_q_local(self) -> int:
        return self.n_heads // self.decode_kv_shards

    @property
    def decode_kv_local(self) -> int:
        return self.n_kv_heads // self.decode_kv_shards


def init_attn(gen, spec: AttnParamsSpec, dtype=torch.float32):
    """Parameter shapes of the train and prefill layout."""
    hd, d = spec.head_dim, spec.d_model
    return {"wq": common.he_init(gen, spec.q_local * hd, d, dtype),
            "wk": common.he_init(gen, spec.kv_local * hd, d, dtype),
            "wv": common.he_init(gen, spec.kv_local * hd, d, dtype),
            "wo": common.he_init(gen, d, spec.q_local * hd, dtype)}


def init_decode_attn(gen, spec: AttnParamsSpec, dtype=torch.float32):
    """Parameter shapes of the decode layout: the q heads of this shard's
    kv group (``decode_q_local``), its kv heads, and ``wo`` over the
    ``n_heads / tp`` q heads it keeps (at tp = 1 the same as
    ``init_attn``'s)."""
    hd, d = spec.head_dim, spec.d_model
    q_loc = spec.n_heads if spec.replicated else spec.decode_q_local
    keep = (spec.n_heads if (spec.replicated or spec.tp == 1)
            else spec.n_heads // spec.tp)
    return {"wq": common.he_init(gen, q_loc * hd, d, dtype),
            "wk": common.he_init(gen, spec.decode_kv_local * hd, d, dtype),
            "wv": common.he_init(gen, spec.decode_kv_local * hd, d, dtype),
            "wo": common.he_init(gen, d, keep * hd, dtype)}


# ---------------------------------------------------------------------------
# chunked online-softmax attention (train / prefill)
# ---------------------------------------------------------------------------

def _block_mask(qp, kp, causal: bool, window):
    """(qc, kc) bool mask of one block, or None where nothing is masked."""
    mask = None
    if causal:
        mask = qp[:, None] >= kp[None, :]
    if window is not None:
        w = (qp[:, None] - kp[None, :]) < window
        mask = w if mask is None else mask & w
    return mask


def _block_is_empty(q0, q1, k0, k1, causal: bool, window) -> bool:
    """True when every (query, key) pair of positions [q0, q1] x [k0, k1]
    is masked."""
    if causal and k0 > q1:
        return True
    return window is not None and q0 - k1 >= window


def chunked_attention(q, k, v, *, causal: bool, window=None,
                      attn_softcap: float | None = None,
                      q_chunk: int = 512, kv_chunk: int = 512,
                      q_offset: int = 0, k_offset: int = 0):
    """q: (B, Sq, G, Hg, hd); k, v: (B, Sk, G, hd) -> (B, Sq, G, Hg, hd).

    G = kv-head groups, Hg = q heads per group; ``window`` None is full
    attention.  Memory is bounded by O(q_chunk * kv_chunk) per (B, G, Hg).
    """
    B, Sq, G, Hg, hd = q.shape
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    assert nq * q_chunk == Sq and nk * kv_chunk == Sk, (Sq, Sk, q_chunk,
                                                        kv_chunk)
    scale = hd ** -0.5
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = k_offset + torch.arange(Sk, device=dev)
    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qc, qp = q[:, qs], q_pos[qs]
        m = torch.full((B, G, Hg, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, G, Hg, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, G, Hg, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        q0, q1 = q_offset + i * q_chunk, q_offset + (i + 1) * q_chunk - 1
        for j in range(nk):
            k0 = k_offset + j * kv_chunk
            if _block_is_empty(q0, q1, k0, k0 + kv_chunk - 1, causal, window):
                continue
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            kc, vc = k[:, ks], v[:, ks]
            s = torch.einsum("bqghd,bkgd->bghqk", qc, kc).float() * scale
            s = softcap(s, attn_softcap)
            mask = _block_mask(qp, k_pos[ks], causal, window)
            if mask is not None:
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bghqk,bkgd->bghqd", p, vc.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B,G,Hg,qc,hd)
        outs.append(torch.movedim(out, 3, 1))                # (B,qc,G,Hg,hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def attn_forward(params, x_sp, spec: AttnParamsSpec, ctx: ShardCtx, *,
                 positions=None, causal=True, window=None,
                 attn_softcap=None, rope_theta=10000.0,
                 mrope_sections=None, mrope_positions=None,
                 kv_override=None, q_chunk=512, kv_chunk=512,
                 return_kv: bool = False, defer_reduce: bool = False):
    """Sequence-parallel attention block body (no norms or residual).

    x_sp: (B, S/tp, D) seq-sharded ((B, S, D) at tp = 1).  kv_override:
    (k, v) for cross-attention, shaped (B, Sk, kv_local, hd).  Returns
    (B, S/tp, D), and (k, v) if requested.
    """
    x = common.sp_all_gather(x_sp, ctx)
    B, S, _ = x.shape
    hd = spec.head_dim

    q = (x @ params["wq"].T).reshape(B, S, spec.q_local, hd)
    if kv_override is None:
        k = (x @ params["wk"].T).reshape(B, S, spec.kv_local, hd)
        v = (x @ params["wv"].T).reshape(B, S, spec.kv_local, hd)
    else:
        k, v = kv_override

    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if mrope_sections is not None:
        mp = (mrope_positions if mrope_positions is not None
              else common.text_mrope_positions(positions))
        q = common.apply_mrope(q, mp, mrope_sections, rope_theta)
        if kv_override is None:
            k = common.apply_mrope(k, mp, mrope_sections, rope_theta)
    elif rope_theta is not None:
        q = common.apply_rope(q, positions, rope_theta)
        if kv_override is None:
            k = common.apply_rope(k, positions, rope_theta)

    # group q heads with their kv heads
    if spec.kv_sharded or spec.replicated or ctx.tp == 1:
        G = k.shape[2]
        qg = q.reshape(B, S, G, spec.q_local // G, hd)
        kg, vg = k, v
    else:
        # kv replicated, q column-parallel: the kv groups this shard's q
        # heads [idx * q_local, (idx + 1) * q_local) belong to
        idx = common.axis_index(ctx)
        gsz = spec.group_size
        if spec.q_local >= gsz:
            # the local q heads span whole groups
            G = spec.q_local // gsz
            g0 = idx * G
            qg = q.reshape(B, S, G, gsz, hd)
        else:
            # several shards share one group
            G = 1
            g0 = (idx * spec.q_local) // gsz
            qg = q.reshape(B, S, 1, spec.q_local, hd)
        kg, vg = k[:, :, g0:g0 + G], v[:, :, g0:g0 + G]
    out = chunked_attention(qg, kg, vg, causal=causal, window=window,
                            attn_softcap=attn_softcap,
                            q_chunk=q_chunk, kv_chunk=kv_chunk)
    y = out.reshape(B, S, spec.q_local * hd) @ params["wo"].T
    if defer_reduce:
        return y
    y = common.sp_reduce_scatter(y, ctx)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# cached decode (one token)
# ---------------------------------------------------------------------------

def decode_groups(spec: AttnParamsSpec, ctx: ShardCtx):
    """axis_index_groups of the within-group LSE combine, or None."""
    if ctx.tp == 1 or spec.decode_seq_parts == 1:
        return None
    r = spec.decode_seq_parts
    return [[g * r + j for j in range(r)] for g in range(ctx.tp // r)]


def ring_write(cache_k, cache_v, k_new, v_new, pos: int, part: int,
               parts: int):
    """Write one token's k, v into the ring buffer, in place, where this
    shard owns the slot.  The ring has ``parts * S_loc`` slots, part
    ``part`` holding slots ``[part * S_loc, (part + 1) * S_loc)``; the
    token goes to slot ``pos % S`` (the reference's owner and clamped
    local slot: ``dynamic_update_slice`` clamps its start index)."""
    S_loc = cache_k.shape[2]
    slot = pos % (parts * S_loc)
    owner = slot // S_loc
    if part != owner:
        return
    local_slot = min(max(slot - owner * S_loc, 0), S_loc - 1)
    cache_k[:, :, local_slot] = k_new
    cache_v[:, :, local_slot] = v_new


def ring_valid(S_loc: int, pos: int, window, device, part: int,
               parts: int) -> torch.Tensor:
    """(S_loc,) bool: local slot j holds a token to attend to.  The
    reference's arithmetic on the global slot index ``g = part * S_loc +
    j``: ``g <= pos`` and ``g > pos - S``, within ``window`` of ``pos``."""
    g = part * S_loc + torch.arange(S_loc, device=device)
    valid = (g <= pos) & (g > pos - parts * S_loc)
    if window is not None:
        valid &= (pos - g) < window
    return valid


def decode_attn_forward(params, x, cache_k, cache_v, pos: int,
                        spec: AttnParamsSpec, ctx: ShardCtx, *, window=None,
                        attn_softcap=None, rope_theta=10000.0,
                        mrope_sections=None, cross_kv=None):
    """One-token cached attention over a sequence-sharded KV cache.

    x: (B, D), replicated over tp; cache_k/v: (B, kv_dec_local, S_loc,
    hd), written in place at the ring slot of ``pos`` (the index of the
    token being generated) by the shard that owns it.  The params are in
    the decode layout (``init_decode_attn``).  Returns (y (B, D),
    replicated, cache_k, cache_v).
    """
    B, d = x.shape
    hd = spec.head_dim
    r = spec.decode_seq_parts
    idx = common.axis_index(ctx)
    part = idx % r
    q = (x @ params["wq"].T).reshape(
        B, spec.n_heads if spec.replicated else spec.decode_q_local, hd)
    pos_b = torch.full((B, 1), pos, device=x.device)
    if mrope_sections is not None:
        mp = common.text_mrope_positions(pos_b)
        q = common.apply_mrope(q[:, None], mp, mrope_sections, rope_theta)[:, 0]
    elif rope_theta is not None:
        q = common.apply_rope(q[:, None], pos_b, rope_theta)[:, 0]

    if cross_kv is None:
        k_new = (x @ params["wk"].T).reshape(B, cache_k.shape[1], hd)
        v_new = (x @ params["wv"].T).reshape(B, cache_v.shape[1], hd)
        if mrope_sections is not None:
            mp = common.text_mrope_positions(pos_b)
            k_new = common.apply_mrope(k_new[:, None], mp, mrope_sections,
                                       rope_theta)[:, 0]
        elif rope_theta is not None:
            k_new = common.apply_rope(k_new[:, None], pos_b, rope_theta)[:, 0]
        ring_write(cache_k, cache_v, k_new, v_new, pos, part, r)
        kq, vq = cache_k, cache_v
        valid = ring_valid(cache_k.shape[2], pos, window, x.device, part, r)
    else:
        kq, vq = cross_kv
        valid = None

    G_loc = kq.shape[1]
    qg = q.reshape(B, G_loc, q.shape[1] // G_loc, hd)
    s = torch.einsum("bghd,bgsd->bghs", qg, kq).float() * hd ** -0.5
    s = softcap(s, attn_softcap)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bghs,bgsd->bghd", p, vq.float())

    groups = decode_groups(spec, ctx)
    if groups is not None:
        # log-sum-exp combine of the group's r sequence parts
        m_g = common.pmax_tp(m, ctx, groups)
        w = torch.exp(m - m_g)
        l = common.psum_tp(l * w, ctx, groups)
        o = common.psum_tp(o * w[..., None], ctx, groups)
    out = (o / torch.clamp(l, min=1e-30)[..., None]).to(x.dtype)
    out = out.reshape(B, -1, hd)                       # (B, dec_q_local, hd)

    if not spec.replicated and ctx.tp > 1:
        # keep this shard's q-head slice: row-parallel wo, then psum
        keep = spec.n_heads // ctx.tp
        out = out[:, part * keep:(part + 1) * keep]
        y = out.reshape(B, keep * hd) @ params["wo"].T
        y = common.psum_tp(y, ctx)
    else:
        y = out.reshape(B, -1) @ params["wo"].T
    return y, cache_k, cache_v
