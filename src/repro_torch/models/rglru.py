"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of ``repro.models.rglru``, per-shard code.  Real-Gated Linear
Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference scans the sequence with ``jax.lax.associative_scan``; here
:func:`rglru_scan` is a Hillis-Steele scan of ceil(log2 S) steps with the
same first-order linear combine.  The two sum in different orders, so
they agree within a tolerance, not bit for bit.  ``jax.nn.gelu`` is the
tanh form (``mlp.gelu``).

Tensor parallelism: the width is sharded over tp (``width_local``); the
gate matrices ``w_a`` and ``w_i`` are the shard's own (W/tp x W/tp), so
at tp > 1 the model's gates are block-diagonal (not the tp = 1 function
of the same full weights); ``w_out`` is row-parallel, its partial sums
reduce-scattered (psummed in the decode step).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import ShardCtx
from repro_torch.models.mlp import gelu
from repro_torch.models.ssm import _causal_conv

RGLRU_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_model: int
    width: int            # lru_width (full)
    d_conv: int = 4

    def width_local(self, tp: int) -> int:
        assert self.width % tp == 0
        return self.width // tp


def init_rglru(gen, spec: RGLRUSpec, tp: int = 1, dtype=torch.float32):
    wl = spec.width_local(tp)
    d = spec.d_model
    dev = gen.device
    # Lambda so that a^c lies in [0.9, 0.999] (Griffin appendix)
    u = common.uniform(gen, (wl,), 0.9, 0.999)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    return {
        "w_in_x": common.he_init(gen, wl, d, dtype),
        "w_in_g": common.he_init(gen, wl, d, dtype),
        "conv_w": common.normal(gen, (wl, spec.d_conv), 0.2, dtype),
        "conv_b": torch.zeros((wl,), dtype=dtype, device=dev),
        "w_a": common.he_init(gen, wl, wl, dtype),
        "b_a": torch.zeros((wl,), dtype=dtype, device=dev),
        "w_i": common.he_init(gen, wl, wl, dtype),
        "b_i": torch.zeros((wl,), dtype=dtype, device=dev),
        "lam": lam.to(dtype),
        "w_out": common.he_init(gen, d, wl, dtype),
    }


def _rglru_coeffs(params, x):
    """x: (..., W) -> (a, b) recurrence coefficients."""
    r = torch.sigmoid(x @ params["w_a"].T + params["b_a"])
    i = torch.sigmoid(x @ params["w_i"].T + params["b_i"])
    log_a = -RGLRU_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-8)) \
        * (i * x)
    return a, b


def rglru_scan(a, b, initial_h=None):
    """h_t = a_t h_{t-1} + b_t over axis 1 (Hillis-Steele, log depth)."""
    if initial_h is not None:
        # fold the initial state into the first element
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * initial_h
    S = a.shape[1]
    d = 1
    while d < S:
        # element t combines with t - d: (a', b') o (a, b) = (a a', a b' + b)
        a_new = a.clone()
        b_new = b.clone()
        a_new[:, d:] = a[:, d:] * a[:, :-d]
        b_new[:, d:] = a[:, d:] * b[:, :-d] + b[:, d:]
        a, b = a_new, b_new
        d *= 2
    return b


def rglru_block_forward(params, x_sp, spec: RGLRUSpec, ctx: ShardCtx,
                        initial_state=None, return_state: bool = False):
    """Griffin recurrent block.  x_sp (B, S/tp, D) -> (B, S/tp, D)."""
    x = common.sp_all_gather(x_sp, ctx)
    gate = gelu(x @ params["w_in_g"].T)
    u_raw = x @ params["w_in_x"].T
    u = _causal_conv(u_raw, params["conv_w"], params["conv_b"])
    a, b = _rglru_coeffs(params, u)
    h = rglru_scan(a, b, initial_state)
    y = ((h * gate) @ params["w_out"].T).to(x.dtype)
    y = common.sp_reduce_scatter(y, ctx)
    if return_state:
        return y, (h[:, -1], u_raw[:, -(spec.d_conv - 1):, :])
    return y


def rglru_decode_step(params, x, cache, spec: RGLRUSpec, ctx: ShardCtx):
    """One-token step.  x (B, D); cache = (h (B, W/tp), conv tail)."""
    h_prev, conv_tail = cache
    gate = gelu(x @ params["w_in_g"].T)
    u_raw = x @ params["w_in_x"].T                          # (B, W)
    window = torch.cat([conv_tail, u_raw[:, None, :]], dim=1)
    u = torch.einsum("bkc,ck->bc", window, params["conv_w"]) + params["conv_b"]
    a, b = _rglru_coeffs(params, u)
    h = a * h_prev + b
    y = ((h * gate) @ params["w_out"].T).to(x.dtype)
    y = common.psum_tp(y, ctx)
    return y, (h.float(), window[:, 1:, :].to(conv_tail.dtype))
