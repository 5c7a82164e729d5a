"""Dense FFN (gated or plain), column- then row-parallel with
sequence-parallel input and output.  Port of ``repro.models.mlp``: the
params hold this shard's ``d_ff / tp`` slice; up and gate are
column-parallel, down row-parallel, its partial sums reduce-scattered.

``jax.nn.gelu`` defaults to the tanh form, so the reference's ``"gelu"``
and ``"gelu_tanh"`` are one function; here both are
``F.gelu(approximate="tanh")`` (torch defaults to the erf form).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import ShardCtx


def gelu(x):
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_mlp(gen, d_model: int, d_ff_local: int, gated: bool = True,
             dtype=torch.float32):
    p = {"w_up": common.he_init(gen, d_ff_local, d_model, dtype),
         "w_down": common.he_init(gen, d_model, d_ff_local, dtype)}
    if gated:
        p["w_gate"] = common.he_init(gen, d_ff_local, d_model, dtype)
    return p


_ACTS = {"silu": F.silu, "gelu": gelu, "gelu_tanh": gelu, "relu": F.relu}


def act_fn(name: str):
    return _ACTS[name]


def mlp_forward(params, x_sp, ctx: ShardCtx, act: str = "silu",
                defer_reduce: bool = False):
    """x_sp: (B, S/tp, D) -> (B, S/tp, D)."""
    x = common.sp_all_gather(x_sp, ctx)
    h = x @ params["w_up"].T
    if "w_gate" in params:
        h = act_fn(act)(x @ params["w_gate"].T) * h
    else:
        h = act_fn(act)(h)
    y = h @ params["w_down"].T
    if defer_reduce:
        return y
    return common.sp_reduce_scatter(y, ctx)
