"""Architecture assembler: dense, MoE, SSM, hybrid, enc-dec and VLM stacks
from one ArchConfig.

Port of ``repro.models.transformer``, per-shard code (see
``common.ShardCtx``).  Parameters are dict trees of tensors with the
reference's keys; per-layer leaves are stacked on a leading layer axis
under ``"layers"``, ``"superblocks"``, ``"tail"``, ``"enc_layers"`` and
``"dec_layers"``, and each ``jax.lax.scan`` over layers is a Python loop
over that axis.  Serving runs under ``torch.inference_mode()``; the
reference's ``jax.checkpoint`` around each layer (a training memory
trade) has no counterpart.

At tp > 1 (a ``ShardPlan(tp=k)`` and a context on a mesh axis of k
processes): the embedding and LM head are vocab-parallel (Megatron): a
shard holds ``padded_vocab(tp) / tp`` rows, the lookup is masked to the
shard's rows and psummed, the loss is a vocab-parallel cross-entropy and
the greedy token a vocab-parallel argmax.  ``forward_full`` runs the
residual stream sequence-parallel: each shard keeps its S/tp slice
between layers, and the final hidden states are gathered.  Decode takes
the decode layout of the attention params (``ShardPlan(tp,
decode_layout=True)``).

Every weight matrix is (out_rows, in), used as ``x @ w.T``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import attention, common, mlp, moe, rglru, ssm
from repro_torch.models.attention import AttnParamsSpec
from repro_torch.models.common import ShardCtx
from repro_torch.models.moe import MoESpec
from repro_torch.models.rglru import RGLRUSpec
from repro_torch.models.ssm import SSMSpec

MOE_AUX_COEF = 0.01
GLOBAL_WINDOW = 1 << 30  # "no window" sentinel


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 32000
    # attention behaviours
    rope_theta: float = 10000.0
    mrope_sections: tuple | None = None
    attn_softcap: float | None = None
    final_softcap: float | None = None
    window: int | None = None
    local_global_period: int = 0    # 0: all global; k: every k-th layer global
    act: str = "silu"
    embed_scale: bool = False
    tie_embeddings: bool = True
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "dense_tp"
    # ssm / hybrid
    ssm_d_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    hybrid_pattern: tuple = ()      # e.g. ("R", "R", "A")
    rglru_width: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_ctx: int = 0
    # vlm
    num_image_tokens: int = 0
    # compute variants
    parallel_block: bool = False    # fused attn+FFN
    sp_int8: bool = False           # int8 SP gathers (tp > 1 only)
    q_chunk: int = 512
    kv_chunk: int = 512
    dtype: Any = torch.float32
    citation: str = ""

    # ------------------------------------------------------ derived specs
    def padded_vocab(self, tp: int) -> int:
        mult = 128 * tp
        return ((self.vocab + mult - 1) // mult) * mult

    def attn_spec(self, tp: int, replicated: bool) -> AttnParamsSpec:
        return AttnParamsSpec(self.n_heads, self.n_kv_heads, self.head_dim,
                              self.d_model, tp=tp, replicated=replicated)

    def moe_spec(self) -> MoESpec:
        return MoESpec(self.n_experts, self.top_k, self.d_model, self.d_ff,
                       self.capacity_factor, self.act, self.moe_impl)

    def ssm_spec(self) -> SSMSpec:
        return SSMSpec(self.d_model, d_state=self.ssm_d_state,
                       head_dim=self.ssm_head_dim, expand=self.ssm_expand)

    def rglru_spec(self) -> RGLRUSpec:
        return RGLRUSpec(self.d_model, self.rglru_width or self.d_model)

    def layer_windows(self, seq_hint: int = 0) -> list:
        """Per-layer window sizes (GLOBAL_WINDOW => full attention)."""
        out = []
        for i in range(self.n_layers):
            if self.window is None:
                out.append(GLOBAL_WINDOW)
            elif self.local_global_period and (i % self.local_global_period
                                               == self.local_global_period - 1):
                out.append(GLOBAL_WINDOW)   # global layer
            else:
                out.append(self.window)
        return out

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers (3 for a hybrid), d_model 256, at
        most 4 experts."""
        kv = max(1, min(self.n_kv_heads, 2))
        heads = max(kv, min(self.n_heads, 4))
        heads = (heads // kv) * kv or kv
        pattern = self.hybrid_pattern[:3] if self.hybrid_pattern else ()
        new_hd = 64 if self.head_dim else 0
        sections = self.mrope_sections
        if sections and new_hd:
            scale = (new_hd // 2) / sum(sections)
            sections = tuple(int(s * scale) for s in sections)
            sections = ((sections[0] + (new_hd // 2 - sum(sections)),)
                        + sections[1:])
        return dataclasses.replace(
            self,
            name=self.name + "_reduced",
            n_layers=3 if pattern else 2,
            d_model=256, n_heads=heads, n_kv_heads=kv,
            head_dim=new_hd, mrope_sections=sections,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # drop-free routing at smoke scale so prefill == decode exactly
            capacity_factor=4.0 if self.n_experts else self.capacity_factor,
            window=min(self.window, 64) if self.window else None,
            rglru_width=256 if self.rglru_width else 0,
            ssm_d_state=min(self.ssm_d_state, 32) if self.ssm_d_state else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_ctx=min(self.encoder_ctx, 64) if self.encoder_ctx else 0,
            num_image_tokens=min(self.num_image_tokens, 8),
            q_chunk=64, kv_chunk=64,
        )


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static sharding decisions for one arch on one mesh."""
    tp: int = 1
    attn_replicated: bool = False
    decode_layout: bool = False       # attention params in decode sharding

    def ctx(self, tp_axis: str | None = None,
            seq_parallel: bool = True) -> ShardCtx:
        return ShardCtx(tp_axis=tp_axis, tp_size=self.tp,
                        attn_replicated=self.attn_replicated,
                        seq_parallel=seq_parallel)


SINGLE = ShardPlan()

# Param-dict keys whose leaves are stacked along a scanned layer axis.
STACKED_KEYS = ("layers", "superblocks")


class ParamSource:
    """Indirection for parameter access, as the reference's: ``stack(name)
    -> (xs, hook)``, where xs leads with the layer axis and ``hook(slice)``
    gives one layer's tree; ``top()`` the non-stacked params."""

    def __init__(self, params: dict):
        self._p = params

    def has(self, name: str) -> bool:
        return name in self._p

    def top(self) -> dict:
        return {k: v for k, v in self._p.items() if k not in STACKED_KEYS}

    def stack(self, name: str):
        return self._p[name], lambda x: x


def as_source(params) -> ParamSource:
    return params if isinstance(params, ParamSource) else ParamSource(params)


def layer_at(tree, i: int):
    """Layer ``i`` of a tree stacked on a leading layer axis."""
    if isinstance(tree, dict):
        return {k: layer_at(v, i) for k, v in tree.items()}
    return tree[i]


def n_stacked(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def layers_of(src: ParamSource, name: str):
    """One tree a layer of the stack ``name``, in order."""
    xs, hook = src.stack(name)
    return [hook(layer_at(xs, i)) for i in range(n_stacked(xs))]


# ===========================================================================
# parameter initialisation
# ===========================================================================

def _init_layer(gen, cfg: ArchConfig, plan: ShardPlan, kind: str):
    """kind: 'attn' | 'moe' | 'mlp' | 'ssm' | 'rglru' | 'cross'."""
    spec = cfg.attn_spec(plan.tp, plan.attn_replicated)
    dt = cfg.dtype
    dev = gen.device

    def zeros():
        return torch.zeros((cfg.d_model,), dtype=dt, device=dev)

    if kind == "ssm":
        return {"ln1": zeros(),
                "ssm": ssm.init_ssm(gen, cfg.ssm_spec(), plan.tp, dt)}
    if kind == "rglru":
        return {"ln1": zeros(),
                "rec": rglru.init_rglru(gen, cfg.rglru_spec(), plan.tp, dt),
                "ln2": zeros(),
                "mlp": mlp.init_mlp(gen, cfg.d_model, cfg.d_ff // plan.tp,
                                    True, dt)}
    attn_init = (attention.init_decode_attn if plan.decode_layout
                 else attention.init_attn)
    p = {"ln1": zeros(), "attn": attn_init(gen, spec, dt), "ln2": zeros()}
    if kind == "cross":
        p["lnx"] = zeros()
        p["xattn"] = attn_init(gen, spec, dt)
    if kind == "moe":
        p["moe"] = moe.init_moe(gen, cfg.moe_spec(), plan.tp, dt)
    else:
        p["mlp"] = mlp.init_mlp(gen, cfg.d_model, cfg.d_ff // plan.tp,
                                cfg.act != "gelu_plain", dt)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig,
                plan: ShardPlan = SINGLE, *, keep=None):
    """Random parameters drawn from ``gen`` on its device (the reference's
    shapes and distributions; the values are the generator's).

    ``keep(path, leaf)``, when given, maps each leaf as it is drawn (a
    layer's leaf, before stacking; ``path`` the tree's keys, the stack's
    name first) to what is kept of it: ``convert.init_shard_params``
    keeps a shard's slice of a full-width tree without holding the
    tree."""
    def kept(prefix, tree):
        if keep is None:
            return tree
        if isinstance(tree, dict):
            return {k: kept(prefix + (k,), v) for k, v in tree.items()}
        return keep(prefix, tree)

    vl = cfg.padded_vocab(plan.tp) // plan.tp
    params: dict = {
        "embed": kept(("embed",), common.embed_init(gen, vl, cfg.d_model,
                                                    cfg.dtype)),
        "final_ln": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = kept(("lm_head",), common.embed_init(
            gen, vl, cfg.d_model, cfg.dtype))

    def stack_of(kinds, prefix):
        # layer by layer into preallocated stacks: a full-width stack is
        # tens of GB, and stacking finished layers would hold it twice
        first = kept(prefix, _init_layer(gen, cfg, plan, kinds[0]))

        def alloc(t):
            if isinstance(t, dict):
                return {k: alloc(v) for k, v in t.items()}
            out = torch.empty((len(kinds),) + tuple(t.shape), dtype=t.dtype,
                              device=t.device)
            out[0] = t
            return out

        out = alloc(first)
        del first
        for i, kind in enumerate(kinds[1:], 1):
            _assign(out, kept(prefix, _init_layer(gen, cfg, plan, kind)), i)
        return out

    if cfg.family in ("ssm", "moe"):
        kind = "ssm" if cfg.family == "ssm" else "moe"
        params["layers"] = stack_of([kind] * cfg.n_layers, ("layers",))
    elif cfg.family == "hybrid":
        pat = cfg.hybrid_pattern
        n_super = cfg.n_layers // len(pat)
        tail = cfg.n_layers - n_super * len(pat)
        kinds = ["rglru" if k == "R" else "attn" for k in pat]
        params["superblocks"] = {
            f"sub{j}": stack_of([kinds[j]] * n_super,
                                ("superblocks", f"sub{j}"))
            for j in range(len(pat))}
        if tail:
            params["tail"] = stack_of([kinds[i % len(pat)]
                                       for i in range(tail)], ("tail",))
    elif cfg.family == "encdec":
        params["enc_layers"] = stack_of(["attn"] * cfg.encoder_layers,
                                        ("enc_layers",))
        params["dec_layers"] = stack_of(["cross"] * cfg.n_layers,
                                        ("dec_layers",))
        params["enc_final_ln"] = torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                             device=gen.device)
    else:  # dense / vlm
        params["layers"] = stack_of(["attn"] * cfg.n_layers, ("layers",))
    return params


def param_shapes(cfg: ArchConfig, plan: ShardPlan = SINGLE):
    """The tree of ``init_params``'s shapes, allocating nothing."""
    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)
    return shapes(init_params(common.MetaGenerator(), cfg, plan))


def _assign(stacked, tree, i: int):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _assign(stacked[k], v, i)
    else:
        stacked[i] = tree


# ===========================================================================
# embedding / head
# ===========================================================================

def embed_lookup(params, tokens, cfg: ArchConfig, plan: ShardPlan,
                 ctx: ShardCtx):
    """tokens (B, S) -> (B, S, D), psum-complete across tp: each shard
    looks up the tokens of its vocab rows, zero elsewhere."""
    vl = params["embed"].shape[0]
    local = tokens - common.axis_index(ctx) * vl
    valid = (local >= 0) & (local < vl)
    x = params["embed"][torch.clamp(local, 0, vl - 1).long()]
    x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    x = common.psum_tp(x, ctx)
    if cfg.embed_scale:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model),
                                        device=x.device)).to(x.dtype)
    return x


def head_logits(x, params, cfg: ArchConfig):
    """x (..., D) -> soft-capped float32 logits over the padded vocab (at
    tp > 1, over this shard's vocab rows)."""
    head = params.get("lm_head", params["embed"])
    return common.softcap((x @ head.T).float(), cfg.final_softcap)


def vocab_parallel_xent(x, labels, params, cfg: ArchConfig, ctx: ShardCtx):
    """x (B, S, D) full-seq activations -> mean token cross-entropy, the
    logits vocab-parallel (never gathered): a pmax shift, the psum of the
    shards' exp-sums and of the label's logit (from the shard that holds
    it)."""
    logits = head_logits(x, params, cfg)                # (B, S, V/tp)
    vl = logits.shape[-1]
    m = common.pmax_tp(torch.amax(logits, dim=-1), ctx)
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    se = common.psum_tp(se, ctx)
    local_lab = labels - common.axis_index(ctx) * vl
    lab_valid = (local_lab >= 0) & (local_lab < vl)
    lab_logit = torch.gather(
        logits, -1, torch.clamp(local_lab, 0, vl - 1)[..., None].long()
    )[..., 0]
    lab_logit = common.psum_tp(torch.where(lab_valid, lab_logit, 0.0), ctx)
    nll = torch.log(se) + m - lab_logit
    return torch.mean(nll)


def greedy_token(x, params, cfg: ArchConfig, ctx: ShardCtx):
    """x (B, D) -> (greedy next token ids (B,) int32, their logits), a
    vocab-parallel argmax: the pmax of the shards' maxima, then the pmin
    of the ids that reach it, so a tie across shards takes the lowest
    id."""
    logits = head_logits(x, params, cfg)
    vl = logits.shape[-1]
    loc_max = torch.amax(logits, dim=-1)
    # torch.argmax returns the first maximum, as jnp.argmax does
    loc_arg = torch.argmax(logits, dim=-1) + common.axis_index(ctx) * vl
    if ctx.tp == 1:
        return loc_arg.to(torch.int32), loc_max
    g_max = common.pmax_tp(loc_max, ctx)
    cand = torch.where(loc_max >= g_max, loc_arg,
                       torch.iinfo(torch.int32).max).to(torch.int32)
    return common.pmin_tp(cand, ctx), g_max


# ===========================================================================
# forward (training / prefill)
# ===========================================================================

def _slice_seq(x, ctx: ShardCtx):
    """Full-seq (B, S, D) -> this shard's seq slice (B, S/tp, D)."""
    if ctx.tp == 1 or not ctx.seq_parallel:
        return x
    S = x.shape[1]
    if S % ctx.tp:
        raise ValueError(f"sequence parallelism needs the sequence ({S}) "
                         f"to divide by tp ({ctx.tp})")
    n = S // ctx.tp
    i = common.axis_index(ctx)
    return x[:, i * n:(i + 1) * n]


def _attn_layer(p, x, cfg, spec, ctx, window, positions=None,
                mrope_positions=None, causal=True, cross_kv=None,
                return_kv=False):
    if cfg.parallel_block and cross_kv is None and not return_kv \
            and "mlp" in p:
        # PaLM-style parallel block: one gather feeds both branches, their
        # partial outputs sum into one reduce-scatter
        h = common.sp_all_gather(common.rms_norm(x, p["ln1"]), ctx)
        flat = dataclasses.replace(ctx, seq_parallel=False)
        ya = attention.attn_forward(
            p["attn"], h, spec, flat, positions=positions, causal=causal,
            window=window, attn_softcap=cfg.attn_softcap,
            rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
            mrope_positions=mrope_positions, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk, defer_reduce=True)
        ym = mlp.mlp_forward(p["mlp"], h, flat, cfg.act, defer_reduce=True)
        return x + common.sp_reduce_scatter(ya + ym, ctx), 0.0
    h = common.rms_norm(x, p["ln1"])
    res = attention.attn_forward(
        p["attn"], h, spec, ctx, positions=positions, causal=causal,
        window=window, attn_softcap=cfg.attn_softcap,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        mrope_positions=mrope_positions,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, return_kv=return_kv)
    if return_kv:
        res, kv = res
    x = x + res
    if cross_kv is not None:
        hx = common.rms_norm(x, p["lnx"])
        x = x + attention.attn_forward(
            p["xattn"], hx, spec, ctx, causal=False, rope_theta=None,
            kv_override=cross_kv, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    h2 = common.rms_norm(x, p["ln2"])
    if "moe" in p:
        y, aux = moe.moe_forward(p["moe"], h2, cfg.moe_spec(), ctx)
    else:
        y, aux = mlp.mlp_forward(p["mlp"], h2, ctx, cfg.act), 0.0
    x = x + y
    if return_kv:
        return x, aux, kv
    return x, aux


def _recurrent_layer(lp, x, cfg, ctx, want_cache: bool):
    """A hybrid's R layer: RG-LRU block and MLP, each with its residual."""
    h = common.rms_norm(x, lp["ln1"])
    if want_cache:
        y, st = rglru.rglru_block_forward(lp["rec"], h, cfg.rglru_spec(), ctx,
                                          return_state=True)
    else:
        y, st = rglru.rglru_block_forward(lp["rec"], h, cfg.rglru_spec(),
                                          ctx), 0.0
    x = x + y
    h2 = common.rms_norm(x, lp["ln2"])
    return x + mlp.mlp_forward(lp["mlp"], h2, ctx, cfg.act), st


def forward_full(params, tokens, cfg: ArchConfig, plan: ShardPlan,
                 ctx: ShardCtx, *, enc_embeds=None, patch_embeds=None,
                 patch_positions=None, mrope_positions=None,
                 collect_cache: bool = False):
    """Full-sequence forward -> (x (B, S, D), aux_loss, cache | None).

    enc_embeds: (B, enc_ctx, D) stub frontend output (encdec);
    patch_embeds (B, n_img, D) and patch_positions (B, n_img): VLM stub.
    The cache, when collected, has the reference's structure: per-layer
    states stacked on a leading layer axis.  Between layers each shard
    holds its S/tp slice of the residual stream; the returned x is whole
    on every shard.
    """
    src = as_source(params)
    top = src.top()
    spec = cfg.attn_spec(plan.tp, plan.attn_replicated)
    x = embed_lookup(top, tokens, cfg, plan, ctx)
    if patch_embeds is not None:
        b_idx = torch.arange(x.shape[0], device=x.device)[:, None]
        x = x.clone()
        x[b_idx, patch_positions.long()] = patch_embeds.to(x.dtype)
    x = _slice_seq(x, ctx)

    aux_total = 0.0
    cache = None

    if cfg.family == "ssm":
        sspec = cfg.ssm_spec()
        states = []
        for lp in layers_of(src, "layers"):
            h = common.rms_norm(x, lp["ln1"])
            if collect_cache:
                y, st = ssm.ssm_forward(lp["ssm"], h, sspec, ctx,
                                        return_state=True)
                states.append(st)
            else:
                y = ssm.ssm_forward(lp["ssm"], h, sspec, ctx)
            x = x + y
        if collect_cache:
            cache = _stack_states(states)

    elif cfg.family == "hybrid":
        pat = cfg.hybrid_pattern
        win = cfg.window or GLOBAL_WINDOW

        def sub_forward(x, lp, kind):
            if kind == "R":
                return _recurrent_layer(lp, x, cfg, ctx, collect_cache)
            if collect_cache:
                x, _, kv = _attn_layer(lp, x, cfg, spec, ctx, win,
                                       return_kv=True)
                return x, kv
            x, _ = _attn_layer(lp, x, cfg, spec, ctx, win)
            return x, 0.0

        sts = []
        for sp in layers_of(src, "superblocks"):
            per = []
            for j, kind in enumerate(pat):
                x, st = sub_forward(x, sp[f"sub{j}"], kind)
                per.append(st)
            sts.append(tuple(per))
        if collect_cache:
            cache = {"super": tuple(_stack_states([s[j] for s in sts])
                                    for j in range(len(pat)))}
        if src.has("tail"):
            tail_sts = []
            for i, lp in enumerate(layers_of(src, "tail")):
                x, st = sub_forward(x, lp, pat[i % len(pat)])
                tail_sts.append(st)
            if collect_cache:
                cache["tail"] = tail_sts

    elif cfg.family == "encdec":
        enc = _slice_seq(enc_embeds.to(cfg.dtype), ctx)
        for lp in layers_of(src, "enc_layers"):
            enc, _ = _attn_layer(lp, enc, cfg, spec, ctx, GLOBAL_WINDOW,
                                 causal=False)
        enc = common.sp_all_gather(common.rms_norm(enc, top["enc_final_ln"]),
                                   ctx)
        kvs = []
        for lp in layers_of(src, "dec_layers"):
            # cross k, v from the encoder output with this layer's xattn
            B, Se = enc.shape[:2]
            kx = (enc @ lp["xattn"]["wk"].T).reshape(B, Se, -1, cfg.head_dim)
            vx = (enc @ lp["xattn"]["wv"].T).reshape(B, Se, -1, cfg.head_dim)
            if collect_cache:
                x, _, kv = _attn_layer(lp, x, cfg, spec, ctx, GLOBAL_WINDOW,
                                       cross_kv=(kx, vx), return_kv=True)
                kvs.append((kv, (kx, vx)))
            else:
                x, _ = _attn_layer(lp, x, cfg, spec, ctx, GLOBAL_WINDOW,
                                   cross_kv=(kx, vx))
        if collect_cache:
            cache = _stack_states(kvs)

    else:  # dense / moe / vlm
        kvs = []
        for lp, win in zip(layers_of(src, "layers"), cfg.layer_windows()):
            if collect_cache:
                x, a, kv = _attn_layer(lp, x, cfg, spec, ctx, win,
                                       mrope_positions=mrope_positions,
                                       return_kv=True)
                kvs.append(kv)
            else:
                x, a = _attn_layer(lp, x, cfg, spec, ctx, win,
                                   mrope_positions=mrope_positions)
            aux_total = aux_total + a
        if collect_cache:
            cache = _stack_states(kvs)

    x = common.sp_all_gather(common.rms_norm(x, top["final_ln"]), ctx)
    return x, aux_total, cache


def _stack_states(per_layer: list):
    """Per-layer tuples of tensors -> one tuple of stacked tensors, as
    ``jax.lax.scan`` stacks its outputs."""
    first = per_layer[0]
    if isinstance(first, tuple):
        return tuple(_stack_states([s[i] for s in per_layer])
                     for i in range(len(first)))
    return torch.stack(per_layer)


def loss_fn(params, batch, cfg: ArchConfig, plan: ShardPlan, ctx: ShardCtx):
    """batch: dict(tokens, labels [, enc_embeds, patch_*, mrope_positions])."""
    x, aux, _ = forward_full(
        params, batch["tokens"], cfg, plan, ctx,
        enc_embeds=batch.get("enc_embeds"),
        patch_embeds=batch.get("patch_embeds"),
        patch_positions=batch.get("patch_positions"),
        mrope_positions=batch.get("mrope_positions"))
    loss = vocab_parallel_xent(x, batch["labels"], as_source(params).top(),
                               cfg, ctx)
    if cfg.n_experts:
        loss = loss + MOE_AUX_COEF * aux / max(cfg.n_layers, 1)
    return loss
