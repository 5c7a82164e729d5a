"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

Port of ``repro.models.ssm``, per-shard code.  Chunked SSD: within a
chunk the quadratic form with the 1-semiseparable decay mask, across
chunks the recurrent chunk states, so the cost is linear in the sequence.
The sequence must divide into chunks of ``spec.chunk``, as in the
reference.

Tensor parallelism: the SSM heads are sharded over tp (``heads_local``);
``in_proj`` holds this shard's rows of each section of ``[z | x | B | C |
dt]``, with B and C (one group) replicated; ``out_proj`` is row-parallel,
its partial sums reduce-scattered (psummed in the decode step).  The
gated RMS norm normalises over the shard's own ``d_inner`` slice, as the
reference's does, so a tp > 1 model is not the tp = 1 function of the
same full weights.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import ShardCtx


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    def heads_local(self, tp: int) -> int:
        assert self.n_heads % tp == 0, (self.n_heads, tp)
        return self.n_heads // tp


def init_ssm(gen, spec: SSMSpec, tp: int = 1, dtype=torch.float32):
    hl = spec.heads_local(tp)
    din_l = hl * spec.head_dim
    gn = spec.n_groups * spec.d_state
    # in_proj rows: [z | x | B | C | dt]
    proj_rows = 2 * din_l + 2 * gn + hl
    conv_ch = din_l + 2 * gn
    dev = gen.device
    return {
        "in_proj": common.he_init(gen, proj_rows, spec.d_model, dtype),
        "conv_w": common.normal(gen, (conv_ch, spec.d_conv), 0.2, dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, hl, device=dev)).to(dtype),
        "D_skip": torch.ones((hl,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((hl,), dtype=dtype, device=dev),
        "norm_g": torch.zeros((din_l,), dtype=dtype, device=dev),
        "out_proj": common.he_init(gen, spec.d_model, din_l, dtype),
    }


def _split_proj(proj, spec: SSMSpec, hl: int):
    din_l = hl * spec.head_dim
    gn = spec.n_groups * spec.d_state
    z = proj[..., :din_l]
    x = proj[..., din_l:2 * din_l]
    Bm = proj[..., 2 * din_l:2 * din_l + gn]
    Cm = proj[..., 2 * din_l + gn:2 * din_l + 2 * gn]
    dt = proj[..., 2 * din_l + 2 * gn:]
    return z, x, Bm, Cm, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv along seq; x (B, S, C), w (C, K)."""
    K = w.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:x.shape[1], :] * w[:, 0]
    for i in range(1, K):
        out = out + pad[:, i:i + x.shape[1], :] * w[:, i]
    return out + b


def ssd_chunked(xbar, Bm, Cm, abar_log, spec: SSMSpec, initial_state=None):
    """Core SSD scan.  xbar (B,S,H,P), abar_log (B,S,H), Bm/Cm (B,S,N)
    [n_groups == 1] -> (y (B,S,H,P), final_state (B,H,N,P))."""
    Bsz, S, H, P = xbar.shape
    N = Bm.shape[-1]
    Q = min(spec.chunk, S)
    nc = S // Q
    assert nc * Q == S, (S, Q)

    xb = xbar.reshape(Bsz, nc, Q, H, P)
    al = abar_log.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    la = torch.cumsum(al, dim=2)                    # (B,nc,Q,H) inclusive
    la_last = la[:, :, -1:, :]                      # (B,nc,1,H)

    # within-chunk (quadratic, masked); the mask goes BEFORE the exp, so
    # the upper triangle cannot overflow to inf
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)           # (B,nc,Q,K)
    decay = la[:, :, :, None, :] - la[:, :, None, :, :]         # (B,nc,Q,K,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=xbar.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], decay, -1e30))
    y_diag = torch.einsum("bcqk,bcqkh,bckhp->bcqhp", scores, L, xb)

    # chunk states: sum_j exp(la_last - la_j) * B_j (x) xbar_j
    w_state = torch.exp(la_last - la)               # (B,nc,Q,H)
    S_local = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc, w_state, xb)

    # inter-chunk recurrence
    chunk_decay = torch.exp(la_last[:, :, 0, :])    # (B,nc,H)
    state = (initial_state if initial_state is not None
             else torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                              device=xbar.device))
    prev = []
    for c in range(nc):
        prev.append(state)                          # state entering chunk c
        state = state * chunk_decay[:, c, :, None, None] + S_local[:, c]
    prev_states = torch.stack(prev, dim=1)          # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(la),
                           prev_states)
    y = (y_diag + y_inter).reshape(Bsz, S, H, P)
    return y, state


def ssm_forward(params, x_sp, spec: SSMSpec, ctx: ShardCtx,
                initial_state=None, return_state: bool = False):
    """x_sp: (B, S/tp, D) -> (B, S/tp, D) [, (ssm state, conv tail)].
    The recurrence runs over the whole sequence, so the seq-parallel
    stream is gathered first."""
    x = common.sp_all_gather(x_sp, ctx)
    Bsz, S, D = x.shape
    hl = params["A_log"].shape[0]
    P = spec.head_dim

    proj = x @ params["in_proj"].T
    z, xs, Bm, Cm, dt = _split_proj(proj, spec, hl)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"],
                                   params["conv_b"]))
    xs = conv_out[..., :hl * P]
    Bm = conv_out[..., hl * P:hl * P + spec.d_state]
    Cm = conv_out[..., hl * P + spec.d_state:]

    dt = F.softplus(dt + params["dt_bias"])               # (B,S,H)
    A = -torch.exp(params["A_log"].float())               # (H,)
    abar_log = dt * A
    xh = xs.reshape(Bsz, S, hl, P)
    xbar = xh * dt[..., None]

    y, state = ssd_chunked(xbar, Bm, Cm, abar_log, spec, initial_state)
    y = y + params["D_skip"][None, None, :, None] * xh
    y = y.reshape(Bsz, S, hl * P)
    y = common.rms_norm(y * F.silu(z), params["norm_g"])
    out = (y @ params["out_proj"].T).to(x.dtype)
    out = common.sp_reduce_scatter(out, ctx)
    if return_state:
        # decode cache: ssm state + conv tail (last d_conv-1 conv inputs)
        return out, (state, conv_in[:, -(spec.d_conv - 1):, :])
    return out


def ssm_decode_step(params, x, cache, spec: SSMSpec, ctx: ShardCtx):
    """One-token step.  x: (B, D); cache = (state (B,H,N,P), conv tail
    (B, d_conv-1, C)) -> (y (B, D), psummed over tp, new cache)."""
    state, conv_tail = cache
    Bsz, D = x.shape
    hl = params["A_log"].shape[0]
    P = spec.head_dim

    proj = x @ params["in_proj"].T
    z, xs, Bm, Cm, dt = _split_proj(proj, spec, hl)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)             # (B, C)
    window = torch.cat([conv_tail, conv_in[:, None, :]], dim=1)   # (B,K,C)
    conv_out = torch.einsum("bkc,ck->bc", window, params["conv_w"]) \
        + params["conv_b"]
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :hl * P]
    Bm = conv_out[..., hl * P:hl * P + spec.d_state]
    Cm = conv_out[..., hl * P + spec.d_state:]

    dt = F.softplus(dt + params["dt_bias"])               # (B,H)
    A = -torch.exp(params["A_log"].float())
    abar = torch.exp(dt * A)                              # (B,H)
    xh = xs.reshape(Bsz, hl, P)
    new_state = (state * abar[:, :, None, None]
                 + torch.einsum("bn,bh,bhp->bhnp", Bm, dt, xh))
    y = torch.einsum("bn,bhnp->bhp", Cm, new_state)
    y = y + params["D_skip"][None, :, None] * xh
    y = y.reshape(Bsz, hl * P)
    y = common.rms_norm(y * F.silu(z), params["norm_g"])
    out = (y @ params["out_proj"].T).to(x.dtype)
    out = common.psum_tp(out, ctx)
    return out, (new_state, window[:, 1:, :])
