"""Mixture-of-Experts layer: top-k router with capacity-factor dispatch.

Port of ``repro.models.moe``'s ``"dense_tp"`` plan at tp = 1: every expert
on one device, dispatch and combine as einsums against a one-hot capacity
tensor.  The ``"ep_a2a"`` plan runs only at tp > 1, where ``ShardCtx``
raises; at tp = 1 the reference takes the dense plan for it too.

Two behaviours of JAX are kept by hand:

* ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
  does not, so the router takes the first k of a stable descending sort;
* ``jax.nn.one_hot`` maps an index outside ``[0, n)`` to a zero row (this
  is how tokens over capacity are dropped); ``F.one_hot`` raises, so the
  one-hot is a comparison with ``arange(n)``.

Router load-balance auxiliary loss as in Switch and Mixtral:
``aux = E * sum_e f_e * p_e`` with f the dispatch fraction and p the mean
gate probability.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import common
from repro_torch.models.common import ShardCtx
from repro_torch.models.mlp import act_fn


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int            # per-expert hidden (full, pre-sharding)
    capacity_factor: float = 1.25
    act: str = "silu"
    impl: str = "dense_tp"   # | "ep_a2a" (the same layout at tp = 1)


def init_moe(gen, spec: MoESpec, dtype=torch.float32):
    e, ffl = spec.n_experts, spec.d_ff
    scale_in = math.sqrt(1.0 / spec.d_model)
    scale_out = math.sqrt(1.0 / spec.d_ff)
    return {
        "router": common.he_init(gen, spec.n_experts, spec.d_model, dtype),
        "w_gate": common.normal(gen, (e, ffl, spec.d_model), scale_in, dtype),
        "w_up": common.normal(gen, (e, ffl, spec.d_model), scale_in, dtype),
        "w_down": common.normal(gen, (e, spec.d_model, ffl), scale_out, dtype),
    }


def one_hot(idx, n: int):
    """``jax.nn.one_hot`` in float32: an index outside [0, n) is a zero
    row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: ties go to the lower index."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(x_flat, router, spec: MoESpec):
    """x_flat: (T, D) -> gates (T, k), expert ids (T, k), probs (T, E)."""
    logits = x_flat @ router.T
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, ids = top_k(probs, spec.top_k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return gate_vals, ids, probs


def _capacity(T: int, spec: MoESpec) -> int:
    c = int(spec.capacity_factor * T * spec.top_k / spec.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def _dispatch_tensors(gate_vals, ids, T: int, cap: int, spec: MoESpec):
    """Position-in-expert assignment -> dispatch mask and combine (T, E, C)."""
    E = spec.n_experts
    onehot = one_hot(ids, E)                                     # (T, k, E)
    pos = torch.cumsum(onehot.reshape(T * spec.top_k, E), dim=0)
    pos = pos.reshape(T, spec.top_k, E) - 1.0
    keep = (pos < cap) & (onehot > 0)
    pos_oh = one_hot(pos.to(torch.int32), cap)                   # (T,k,E,C)
    sel = onehot * keep
    dispatch = torch.einsum("tke,tkec->tec", sel, pos_oh)
    combine = torch.einsum("tk,tke,tkec->tec", gate_vals, sel, pos_oh)
    return dispatch, combine


def moe_forward(params, x_sp, spec: MoESpec, ctx: ShardCtx):
    """x: (B, S, D) -> (y (B, S, D), aux_loss scalar)."""
    x = common.sp_all_gather(x_sp, ctx)
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    gate_vals, ids, probs = _route(xf, params["router"], spec)
    cap = _capacity(T, spec)
    dispatch, combine = _dispatch_tensors(gate_vals, ids, T, cap, spec)

    # load-balance aux (Switch): E * sum_e f_e * p_e
    f = torch.mean((torch.sum(dispatch, dim=2) > 0).float(), dim=0)
    p = torch.mean(probs, dim=0)
    aux = spec.n_experts * torch.sum(f * p)

    expert_in = torch.einsum("tec,td->ecd", dispatch, xf)        # (E,C,D)
    h = torch.einsum("ecd,efd->ecf", expert_in, params["w_gate"])
    h = act_fn(spec.act)(h) * torch.einsum("ecd,efd->ecf", expert_in,
                                           params["w_up"])
    out = torch.einsum("ecf,edf->ecd", h, params["w_down"])
    y = torch.einsum("tec,ecd->td", combine, out)
    y = y.reshape(B, S, D).to(x.dtype)
    return common.sp_reduce_scatter(y, ctx), aux
