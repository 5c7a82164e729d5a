"""Shared transformer building blocks, written as per-shard code.

Port of ``repro.models.common``.  Every layer function takes a
``ShardCtx``: at ``tp_size == 1`` every collective is the identity; at tp
> 1 the same code runs Megatron-style tensor parallelism with
sequence-parallel residual streams, one process a shard of the ``model``
axis, over a ``torch.distributed`` process group.

**Where the group lives.**  ``ShardCtx`` is frozen and static, as the
reference's: it names its axis and its size and holds no group.  The
group is resolved from the axis name through the mesh this process built:
``launch.mesh.make_mesh`` makes every group of the mesh once, in every
process and in the same order, and binds each axis it has to an
:class:`Axis` here (:func:`bind_axis`).  A context of tp > 1 whose axis
no mesh has bound raises ``RuntimeError`` at its first collective, naming
the missing group.  ``axis_index`` is the process's rank in the axis's
group.

**The collectives** are ``torch.distributed`` ops on the axis's group:
``psum_tp`` and ``pmax_tp``/``pmin_tp`` are ``all_reduce`` (SUM, MAX,
MIN); ``sp_all_gather`` is ``all_gather`` into a list, concatenated along
the gathered axis (``all_gather_into_tensor`` stacks on dim 0 only);
``sp_reduce_scatter`` moves its axis to dim 0 and calls
``reduce_scatter_tensor`` (the gloo of torch 2.11 has it; from torch 2.13,
where it is deprecated, ``reduce_scatter_single``), chosen by the torch
version.  ``groups=`` stands for the reference's ``axis_index_groups``:
a partition of the axis into blocks of ``r`` consecutive ranks, reduced
on the sub-groups the mesh made for each divisor ``r`` of the axis size.
A group on gloo takes host tensors, so a CUDA tensor is staged through
the host (copied out, reduced, copied back), as ``dist.context`` does;
every rank of a gloo ``all_reduce`` gets the same bits.  Each call is
counted in :data:`COLLECTIVES` (calls, host ns, bytes by op).

Weight layout as in the reference: matrices are (out_dim, in_dim), dim 0
the output rows (the "filters" the paper scales), used as ``x @ w.T``.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Execution context of the reference's per-shard code (all static)."""
    tp_axis: str | None = None        # model axis name of the mesh
    tp_size: int = 1
    dp_axes: tuple = ()               # client/data axes (grad sync outside)
    attn_replicated: bool = False     # tiny archs whose heads don't split
    seq_parallel: bool = True         # residual stream sharded on seq
    sp_int8: bool = False             # int8-quantized SP all-gathers

    @property
    def tp(self) -> int:
        return self.tp_size if self.tp_axis else 1


UNSHARDED = ShardCtx()


# ---------------------------------------------------------------- groups

@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this process sees it: its group, this process's
    index along it, its size, and ``blocks[r]``, the group of the ``r``
    consecutive ranks that hold this process, for each divisor ``r`` of
    the size between 1 and the size."""
    name: str
    group: object
    index: int
    size: int
    blocks: dict


_AXES: dict[str, Axis] = {}

# op -> [calls, host ns, bytes in]
COLLECTIVES: dict[str, list] = {}


def bind_axis(axis: Axis) -> None:
    """Make ``axis`` the group of every context that names it."""
    _AXES[axis.name] = axis


def unbind_axes() -> None:
    _AXES.clear()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def collective_totals() -> tuple[int, float, int]:
    """(calls, host ms, bytes) of every collective since the last reset."""
    calls = sum(v[0] for v in COLLECTIVES.values())
    ms = sum(v[1] for v in COLLECTIVES.values()) / 1e6
    return calls, ms, sum(v[2] for v in COLLECTIVES.values())


def _axis(ctx: ShardCtx) -> Axis:
    ax = _AXES.get(ctx.tp_axis)
    if ax is None:
        raise RuntimeError(
            f"ShardCtx(tp_axis={ctx.tp_axis!r}, tp_size={ctx.tp_size}): no "
            f"process group is bound to the mesh axis {ctx.tp_axis!r} in "
            f"this process; build the mesh with "
            f"repro_torch.launch.mesh.make_mesh inside a joined "
            f"torch.distributed job (one process a shard)")
    if ax.size != ctx.tp_size:
        raise RuntimeError(
            f"ShardCtx(tp_axis={ctx.tp_axis!r}, tp_size={ctx.tp_size}): the "
            f"mesh axis {ctx.tp_axis!r} has {ax.size} processes")
    return ax


def _sharded(ctx: ShardCtx) -> bool:
    return ctx.tp_axis is not None and ctx.tp_size > 1


def _run(op: str, x, fn):
    """``fn(host_or_device_tensor, dist)`` on a contiguous copy of ``x``
    (through the host where the group is gloo and ``x`` is not), counted
    under ``op``; returns the result on ``x``'s device."""
    import torch.distributed as dist
    t0 = time.perf_counter_ns()
    staged = x.device.type != "cpu"
    buf = x.detach().to("cpu", copy=True) if staged else x.detach().clone()
    out = fn(buf.contiguous(), dist)
    if staged:
        out = out.to(x.device)
    rec = COLLECTIVES.setdefault(op, [0, 0, 0])
    rec[0] += 1
    rec[1] += time.perf_counter_ns() - t0
    rec[2] += x.numel() * x.element_size()
    return out


def _group_of(ctx: ShardCtx, groups):
    """The process group of ``groups`` (the reference's
    ``axis_index_groups``: None, or blocks of r consecutive ranks)."""
    ax = _axis(ctx)
    if groups is None:
        return ax.group
    r = len(groups[0])
    want = [[g * r + j for j in range(r)] for g in range(ax.size // r)]
    if [list(g) for g in groups] != want or (r != ax.size
                                             and r not in ax.blocks):
        raise ValueError(f"axis_index_groups {groups} of the axis "
                         f"{ax.name!r} (size {ax.size}): the port reduces "
                         f"over blocks of consecutive ranks only")
    return ax.group if r == ax.size else ax.blocks[r]


def _all_reduce(x, ctx: ShardCtx, op: str, groups=None):
    group = _group_of(ctx, groups)

    def fn(buf, dist):
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, op.upper()),
                        group=group)
        return buf
    return _run(f"p{op}" if groups is None else f"p{op}_groups", x, fn)


def psum_tp(x, ctx: ShardCtx, groups=None):
    """Sum over the tp axis (or within ``groups`` of it)."""
    if not _sharded(ctx):
        return x
    return _all_reduce(x, ctx, "sum", groups)


def pmax_tp(x, ctx: ShardCtx, groups=None):
    if not _sharded(ctx):
        return x
    return _all_reduce(x, ctx, "max", groups)


def pmin_tp(x, ctx: ShardCtx):
    if not _sharded(ctx):
        return x
    return _all_reduce(x, ctx, "min")


def axis_index(ctx: ShardCtx) -> int:
    """This process's index along the tp axis (0 unsharded)."""
    if not _sharded(ctx):
        return 0
    return _axis(ctx).index


def all_gather_tp(x, ctx: ShardCtx, axis: int):
    """The shards' ``x`` concatenated along ``axis`` (tiled), in rank
    order; ``x`` unsharded."""
    if not _sharded(ctx):
        return x
    return _gather(x, ctx, axis)


def _gather(x, ctx: ShardCtx, axis: int):
    ax = _axis(ctx)

    def fn(buf, dist):
        parts = [torch.empty_like(buf) for _ in range(ax.size)]
        dist.all_gather(parts, buf, group=ax.group)
        return torch.cat(parts, dim=axis)
    return _run("all_gather", x, fn)


def sp_all_gather(x, ctx: ShardCtx, axis: int = 1):
    """Gather the sequence-parallel shard dim back to the full sequence.

    With ``ctx.sp_int8`` the payload is per-token symmetric int8 with
    float16 scales, gathered, then dequantized, as the reference's."""
    if not _sharded(ctx) or not ctx.seq_parallel:
        return x
    if not ctx.sp_int8:
        return _gather(x, ctx, axis)
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    qg = _gather(q, ctx, axis)
    sg = _gather(scale.to(torch.float16), ctx, axis)
    return (qg.float() * sg.float()).to(x.dtype)


def _reduce_scatter_fn():
    """``reduce_scatter_single`` from torch 2.13 (where
    ``reduce_scatter_tensor`` is deprecated), ``reduce_scatter_tensor``
    before it."""
    import torch.distributed as dist
    major, minor = (int(v) for v in torch.__version__.split(".")[:2])
    return (dist.reduce_scatter_single if (major, minor) >= (2, 13)
            else dist.reduce_scatter_tensor)


def sp_reduce_scatter(x, ctx: ShardCtx, axis: int = 1):
    """Sum partial outputs across tp and keep this shard's seq slice (a
    psum when the stream is not sequence-parallel)."""
    if not _sharded(ctx):
        return x
    if not ctx.seq_parallel:
        return psum_tp(x, ctx)
    ax = _axis(ctx)
    if x.shape[axis] % ax.size:
        raise ValueError(f"sequence parallelism needs the sequence "
                         f"({x.shape[axis]}) to divide by tp ({ax.size})")
    scatter = _reduce_scatter_fn()

    def fn(buf, dist):
        src = torch.movedim(buf, axis, 0).contiguous()
        out = src.new_empty((src.shape[0] // ax.size,) + src.shape[1:])
        scatter(out, src, group=ax.group)
        return torch.movedim(out, 0, axis)
    return _run("reduce_scatter", x, fn)


# ---------------------------------------------------------------- init

class MetaGenerator:
    """Stands in for a ``torch.Generator`` where only shapes are wanted:
    the init functions then build meta tensors and allocate nothing."""
    device = torch.device("meta")


def normal(gen, shape, std: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws on the generator's device, times ``std``."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def uniform(gen, shape, low: float, high: float) -> torch.Tensor:
    """Uniform float32 draws in [low, high) on the generator's device."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), device="meta")
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return low + (high - low) * u


def he_init(gen, out_d: int, in_d: int, dtype=torch.float32):
    return normal(gen, (out_d, in_d), math.sqrt(1.0 / in_d), dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.float32):
    return normal(gen, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------- norms

def rms_norm(x, gamma, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + gamma)).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def softcap(x, cap: float | None):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    e = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), e)


def _rotate(x, angles):
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # (hd/2,)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    return _rotate(x, angles)


def apply_mrope(x, positions_3d, sections: tuple[int, int, int],
                theta: float = 10000.0):
    """Qwen2-VL multimodal RoPE: the head_dim/2 frequency slots are split
    into (temporal, height, width) sections, each rotated by its own
    position id.  x: (..., S, H, hd); positions_3d: (3, ..., S)."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # (half,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device))         # (half,)
    pos = torch.movedim(positions_3d[sec_id], 0, -1)      # (..., S, half)
    return _rotate(x, pos.float() * freqs)


def text_mrope_positions(positions):
    """Text-only M-RoPE degenerates to the same id on all three axes."""
    return torch.stack([positions, positions, positions], dim=0)


# ---------------------------------------------------------------- losses

def softmax_xent(logits, labels, valid=None):
    """Mean token cross-entropy; logits (..., V), labels (...)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if valid is None:
        return -torch.mean(ll)
    return -torch.sum(ll * valid) / torch.clamp(torch.sum(valid), min=1.0)
