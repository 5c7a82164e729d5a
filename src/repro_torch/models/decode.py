"""Cached decoding (the serve path): cache init, prefill into the cache,
one-token step.

Port of ``repro.models.decode``.  Cache layouts (per shard), as the
reference's:

  dense/moe/vlm : k, v (L, B, kv_dec_local, S_loc, hd), S_loc =
                  cache_len / r (the decode plan's sequence parts)
  ssm           : state (L, B, H_loc, N, P) float32 + conv tail
                  (L, B, K-1, C_loc)
  hybrid        : {"super": one pair a pattern slot, stacked over the
                  superblocks; "tail": one pair a tail layer, leading 1};
                  the RG-LRU state (.., B, W/tp)
  encdec        : {"self": decoder k, v; "cross": static encoder k, v}

At tp > 1 the attention params are in the decode layout (``ShardPlan(tp,
decode_layout=True)``), the MLP and MoE run on one token with contexts
that are not sequence-parallel (their reduce a psum), and a prompt is fed
one token at a time through :func:`decode_step` from :func:`init_cache`,
as the reference serves it: :func:`prefill` builds the single-shard
layout.

``DecodeCache.pos`` is a Python int (the next position to write), so the
ring slot is known on the host.  ``decode_step`` writes the new token's
k, v into the cache's tensors in place and returns the cache with
``pos + 1``: a cache is consumed by the step that takes it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import attention, common, mlp, moe, rglru, ssm, \
    transformer
from repro_torch.models.common import ShardCtx
from repro_torch.models.transformer import GLOBAL_WINDOW, ArchConfig, \
    ShardPlan


class DecodeCache(NamedTuple):
    pos: int             # next position to write
    layers: Any          # family-specific tree


def _kv_cache_shape(cfg: ArchConfig, plan: ShardPlan, batch: int,
                    cache_len: int):
    spec = cfg.attn_spec(plan.tp, plan.attn_replicated)
    s_loc = cache_len // spec.decode_seq_parts
    return (batch, spec.decode_kv_local, s_loc, cfg.head_dim)


def effective_cache_len(cfg: ArchConfig, seq_len: int) -> int:
    """Archs with a window on every layer cap the ring buffer at it."""
    if cfg.window is not None and cfg.local_global_period == 0:
        return min(seq_len, cfg.window)
    return seq_len


def init_cache(cfg: ArchConfig, plan: ShardPlan, batch: int, cache_len: int,
               enc_ctx: int | None = None, device="cpu"):
    dt = cfg.dtype
    L = cfg.n_layers

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv_pair(n_layers):
        shp = (n_layers,) + _kv_cache_shape(cfg, plan, batch, cache_len)
        return (zeros(shp), zeros(shp))

    if cfg.family == "ssm":
        sspec = cfg.ssm_spec()
        hl = sspec.heads_local(plan.tp)
        conv_ch = hl * sspec.head_dim + 2 * sspec.n_groups * sspec.d_state
        layers = (zeros((L, batch, hl, sspec.d_state, sspec.head_dim),
                        torch.float32),
                  zeros((L, batch, sspec.d_conv - 1, conv_ch)))
    elif cfg.family == "hybrid":
        pat = cfg.hybrid_pattern
        n_super = L // len(pat)
        tail = L - n_super * len(pat)
        rspec = cfg.rglru_spec()
        wl = rspec.width_local(plan.tp)

        def sub_cache(kind, n):
            if kind == "R":
                return (zeros((n, batch, wl), torch.float32),
                        zeros((n, batch, rspec.d_conv - 1, wl)))
            return kv_pair(n)

        layers = {
            "super": tuple(sub_cache(k, n_super) for k in pat),
            "tail": tuple(sub_cache(pat[i % len(pat)], 1)
                          for i in range(tail)),
        }
    elif cfg.family == "encdec":
        spec = cfg.attn_spec(plan.tp, plan.attn_replicated)
        ec = enc_ctx or cfg.encoder_ctx
        shp = (L, batch, spec.decode_kv_local, ec, cfg.head_dim)
        layers = {"self": kv_pair(L), "cross": (zeros(shp), zeros(shp))}
    else:
        layers = kv_pair(L)
    return DecodeCache(0, layers)


# ---------------------------------------------------------------------------
# one-token decode step
# ---------------------------------------------------------------------------

def _ffn(lp, h2, cfg, ctx):
    """The layer's MLP or MoE on one token a sequence: (B, D) -> (B, D),
    on the tp axis without sequence parallelism (the reference's
    ``ShardCtx(ctx.tp_axis, ctx.tp_size, seq_parallel=False)``)."""
    flat = ShardCtx(ctx.tp_axis, ctx.tp_size, seq_parallel=False)
    if "moe" in lp:
        y2, _ = moe.moe_forward(lp["moe"], h2[:, None, :], cfg.moe_spec(),
                                flat)
        return y2[:, 0, :]
    return mlp.mlp_forward(lp["mlp"], h2[:, None, :], flat, cfg.act)[:, 0, :]


def _decode_dense_layer(lp, x, ck, cv, pos, cfg, spec, ctx, window,
                        cross_kv=None):
    h = common.rms_norm(x, lp["ln1"])
    y, ck, cv = attention.decode_attn_forward(
        lp["attn"], h, ck, cv, pos, spec, ctx, window=window,
        attn_softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections)
    x = x + y
    if cross_kv is not None:
        hx = common.rms_norm(x, lp["lnx"])
        yx, _, _ = attention.decode_attn_forward(
            lp["xattn"], hx, cross_kv[0], cross_kv[1], pos, spec, ctx,
            rope_theta=None, cross_kv=cross_kv)
        x = x + yx
    return x + _ffn(lp, common.rms_norm(x, lp["ln2"]), cfg, ctx), ck, cv


def _decode_recurrent_layer(lp, x, c, cfg, ctx):
    h = common.rms_norm(x, lp["ln1"])
    y, c2 = rglru.rglru_decode_step(lp["rec"], h, c, cfg.rglru_spec(), ctx)
    x = x + y
    return x + _ffn(lp, common.rms_norm(x, lp["ln2"]), cfg, ctx), c2


def _put(stacked: tuple, i: int, values: tuple):
    """Write one layer's states into a tuple of stacked tensors, in place."""
    for dst, v in zip(stacked, values):
        dst[i].copy_(v)


def decode_hidden(params, cache: DecodeCache, tokens, cfg: ArchConfig,
                  plan: ShardPlan, ctx: ShardCtx):
    """tokens (B,) -> (final-normed hidden state (B, D), cache at pos + 1).
    The cache's tensors are updated in place."""
    src = transformer.as_source(params)
    top = src.top()
    spec = cfg.attn_spec(plan.tp, plan.attn_replicated)
    pos = cache.pos
    x = transformer.embed_lookup(top, tokens[:, None], cfg, plan, ctx)[:, 0]
    layers = cache.layers

    if cfg.family == "ssm":
        sspec = cfg.ssm_spec()
        states, tails = layers
        for i, lp in enumerate(transformer.layers_of(src, "layers")):
            h = common.rms_norm(x, lp["ln1"])
            y, c2 = ssm.ssm_decode_step(lp["ssm"], h, (states[i], tails[i]),
                                        sspec, ctx)
            x = x + y
            _put(layers, i, c2)

    elif cfg.family == "hybrid":
        pat = cfg.hybrid_pattern
        win = cfg.window or GLOBAL_WINDOW
        sup = layers["super"]
        for i, sp in enumerate(transformer.layers_of(src, "superblocks")):
            for j, kind in enumerate(pat):
                sub, c = sp[f"sub{j}"], sup[j]
                if kind == "R":
                    x, c2 = _decode_recurrent_layer(sub, x, (c[0][i], c[1][i]),
                                                    cfg, ctx)
                    _put(c, i, c2)
                else:
                    x, _, _ = _decode_dense_layer(sub, x, c[0][i], c[1][i],
                                                  pos, cfg, spec, ctx, win)
        tail = (transformer.layers_of(src, "tail") if src.has("tail")
                else [])
        for i, (lp, c) in enumerate(zip(tail, layers["tail"])):
            if pat[i % len(pat)] == "R":
                x, c2 = _decode_recurrent_layer(lp, x, (c[0][0], c[1][0]),
                                                cfg, ctx)
                _put(c, 0, c2)
            else:
                x, _, _ = _decode_dense_layer(lp, x, c[0][0], c[1][0], pos,
                                              cfg, spec, ctx, win)

    elif cfg.family == "encdec":
        ck_all, cv_all = layers["self"]
        xk_all, xv_all = layers["cross"]
        for i, lp in enumerate(transformer.layers_of(src, "dec_layers")):
            x, _, _ = _decode_dense_layer(lp, x, ck_all[i], cv_all[i], pos,
                                          cfg, spec, ctx, GLOBAL_WINDOW,
                                          cross_kv=(xk_all[i], xv_all[i]))

    else:  # dense / moe / vlm
        ck_all, cv_all = layers
        for i, (lp, win) in enumerate(zip(transformer.layers_of(src, "layers"),
                                          cfg.layer_windows())):
            x, _, _ = _decode_dense_layer(lp, x, ck_all[i], cv_all[i], pos,
                                          cfg, spec, ctx, win)

    x = common.rms_norm(x, top["final_ln"])
    return x, DecodeCache(pos + 1, layers)


def decode_step(params, cache: DecodeCache, tokens, cfg: ArchConfig,
                plan: ShardPlan, ctx: ShardCtx):
    """tokens (B,) int -> (next_tokens (B,) int32, cache at pos + 1)."""
    x, cache = decode_hidden(params, cache, tokens, cfg, plan, ctx)
    nxt, _ = transformer.greedy_token(x, transformer.as_source(params).top(),
                                      cfg, ctx)
    return nxt, cache


# ---------------------------------------------------------------------------
# prefill -> decode-layout cache
# ---------------------------------------------------------------------------

def _kv_to_cache(kv_stack, cache_kv, length: int):
    """(k, v) (L, B, S, KV, hd) into the cache's (L, B, KV, S_c, hd) from
    slot 0, the first ``length`` positions."""
    k, v = kv_stack
    ck, cv = cache_kv
    ck[:, :, :, :length] = torch.movedim(k, 2, 3)[:, :, :, :length].to(ck.dtype)
    cv[:, :, :, :length] = torch.movedim(v, 2, 3)[:, :, :, :length].to(cv.dtype)
    return ck, cv


def prefill_hidden(params, tokens, cfg: ArchConfig, plan: ShardPlan,
                   ctx: ShardCtx, cache_len: int, **extras):
    """The full-sequence forward into a decode cache -> (final-normed
    hidden states (B, S, D), DecodeCache at pos S).  Single-shard layout,
    as the reference's ``prefill``: at tp > 1 this raises; feed the
    prompt through ``decode_step`` from ``init_cache``."""
    if ctx.tp != 1:
        raise ValueError(
            f"prefill builds the single-shard cache layout and this context "
            f"has tp = {ctx.tp}: feed the prompt one token at a time through "
            f"decode_step from init_cache, as the reference serves tp > 1")
    x, _, collected = transformer.forward_full(
        params, tokens, cfg, plan, ctx, collect_cache=True, **extras)
    B, S = tokens.shape
    enc = extras.get("enc_embeds")
    cache = init_cache(cfg, plan, B, cache_len,
                       enc_ctx=(enc.shape[1] if enc is not None else 1)
                       if cfg.family == "encdec" else None, device=x.device)

    if cfg.family == "ssm":
        layers = collected  # (states, tails) stacked over layers
    elif cfg.family == "hybrid":
        sup = []
        for j, kind in enumerate(cfg.hybrid_pattern):
            col, tgt = collected["super"][j], cache.layers["super"][j]
            sup.append(col if kind == "R"
                       else _kv_to_cache(col, tgt, min(S, tgt[0].shape[3])))
        tail = []
        for i, col in enumerate(collected.get("tail", [])):
            tgt = cache.layers["tail"][i]
            if cfg.hybrid_pattern[i % len(cfg.hybrid_pattern)] == "R":
                tail.append(tuple(a[None] for a in col))
            else:
                k, v = col
                tail.append(_kv_to_cache((k[None], v[None]), tgt,
                                         min(S, tgt[0].shape[3])))
        layers = {"super": tuple(sup), "tail": tuple(tail)}
    elif cfg.family == "encdec":
        self_kv, cross_kv = collected
        tgt = cache.layers["self"]
        layers = {"self": _kv_to_cache(self_kv, tgt, min(S, tgt[0].shape[3])),
                  "cross": tuple(torch.movedim(a, 2, 3).contiguous()
                                 for a in cross_kv)}
    else:
        layers = _kv_to_cache(collected, cache.layers,
                              min(S, cache.layers[0].shape[3]))
    return x, DecodeCache(S, layers)


def prefill(params, tokens, cfg: ArchConfig, plan: ShardPlan, ctx: ShardCtx,
            cache_len: int, **extras):
    """Run the full-seq forward and build a decode cache -> (next tokens
    (B,) int32, DecodeCache)."""
    x, cache = prefill_hidden(params, tokens, cfg, plan, ctx, cache_len,
                              **extras)
    nxt, _ = transformer.greedy_token(x[:, -1], params, cfg, ctx)
    return nxt, cache
