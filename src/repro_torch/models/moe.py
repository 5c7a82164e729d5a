"""Mixture-of-Experts layer: top-k router with capacity-factor dispatch.

Port of ``repro.models.moe``, per-shard code.  Two plans (``impl``):

* ``"dense_tp"``: every shard holds every expert with the expert FFN dim
  sharded over tp (column then row parallel, as the dense MLP); dispatch
  and combine are einsums against a one-hot capacity tensor.
* ``"ep_a2a"``: each shard holds one expert, its width split
  ``tp // n_experts`` ways; needs ``tp % n_experts == 0``.  Routing is
  replicated after the sequence gather, so no all-to-all is needed: each
  shard runs its expert's token block, scatters it into its expert slot,
  and the layer's one reduce sums the expert slots and the width
  partials.  At tp = 1 it is the dense plan.

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
    impl: str = "dense_tp"   # | "ep_a2a"

    def d_ff_local(self, tp: int) -> int:
        if self.impl == "dense_tp":
            assert self.d_ff % tp == 0, (self.d_ff, tp)
            return self.d_ff // tp
        # ep_a2a: full expert width, split by the surplus of tp over E
        width_shards = max(1, tp // self.n_experts)
        assert self.d_ff % width_shards == 0
        return self.d_ff // width_shards

    def experts_local(self, tp: int) -> int:
        if self.impl == "dense_tp":
            return self.n_experts
        return max(1, self.n_experts // tp)


def init_moe(gen, spec: MoESpec, tp: int, dtype=torch.float32):
    e, ffl = spec.experts_local(tp), spec.d_ff_local(tp)
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
    """x_sp: (B, S/tp, D) -> (y (B, S/tp, D), aux_loss scalar)."""
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

    if spec.impl == "ep_a2a" and ctx.tp > 1:
        y = _ep_a2a_forward(params, xf, dispatch, combine, spec, ctx)
    else:
        expert_in = torch.einsum("tec,td->ecd", dispatch, xf)    # (E,C,D)
        h = torch.einsum("ecd,efd->ecf", expert_in, params["w_gate"])
        h = act_fn(spec.act)(h) * torch.einsum("ecd,efd->ecf", expert_in,
                                               params["w_up"])
        out = torch.einsum("ecf,edf->ecd", h, params["w_down"])
        y = torch.einsum("tec,ecd->td", combine, out)
    y = y.reshape(B, S, D).to(x.dtype)
    return common.sp_reduce_scatter(y, ctx), aux


def _ep_a2a_forward(params, xf, dispatch, combine, spec: MoESpec,
                    ctx: ShardCtx):
    """The expert-parallel plan: this shard's expert (its width slice) on
    the expert's token block, scattered into the expert's slot.  The
    result is partial (one expert slot filled); the caller's reduce sums
    the experts and the width partials in one collective."""
    tp, E = ctx.tp, spec.n_experts
    if tp % E:
        raise ValueError(f"ep_a2a needs tp % n_experts == 0 (tp {tp}, "
                         f"{E} experts); use dense_tp")
    T, D = xf.shape
    cap = dispatch.shape[2]
    my_e = common.axis_index(ctx) // (tp // E)
    h_in = torch.einsum("tc,td->cd", dispatch[:, my_e], xf)       # (C, D)
    g = h_in @ params["w_gate"][0].T
    u = h_in @ params["w_up"][0].T
    out = (act_fn(spec.act)(g) * u) @ params["w_down"][0].T       # (C, D)
    full = torch.zeros((E, cap, D), dtype=out.dtype, device=out.device)
    full[my_e] = out
    return torch.einsum("tec,ecd->td", combine, full)
