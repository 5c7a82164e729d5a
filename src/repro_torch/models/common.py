"""Shared transformer building blocks.

Port of ``repro.models.common``.  The reference writes every layer as
per-shard code over a ``ShardCtx``; the port runs at tensor-parallel size
1, where every collective is the identity.  A context that asks for more
(a ``tp_axis`` and ``tp_size > 1``) raises ``runtime.not_ported``.

Weight layout as in the reference: matrices are (out_dim, in_dim), dim 0
the output rows (the "filters" the paper scales), used as ``x @ w.T``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.runtime import not_ported

# the port-queue item that tensor parallelism waits on (ROADMAP.md)
TP_ITEM = "transformer tensor parallel"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Execution context of the reference's per-shard code (all static)."""
    tp_axis: str | None = None
    tp_size: int = 1
    dp_axes: tuple = ()
    attn_replicated: bool = False
    seq_parallel: bool = True
    sp_int8: bool = False

    def __post_init__(self):
        if self.tp > 1:
            raise not_ported(f"a ShardCtx with tp_axis={self.tp_axis!r} and "
                             f"tp_size={self.tp_size}", TP_ITEM)

    @property
    def tp(self) -> int:
        return self.tp_size if self.tp_axis else 1


UNSHARDED = ShardCtx()


# at tp == 1 the collectives of the reference are the identity

def psum_tp(x, ctx: ShardCtx):
    return x


def axis_index(ctx: ShardCtx) -> int:
    return 0


def sp_all_gather(x, ctx: ShardCtx, axis: int = 1):
    return x


def sp_reduce_scatter(x, ctx: ShardCtx, axis: int = 1):
    return x


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
