"""Uniform quantization of differential weight updates (paper §3).

Port of ``repro.core.quant``.  Levels are ``round(x / step)`` with
round-half-to-even (``torch.round``, like ``jnp.round``), clipped to
``±max_level`` and stored as int32.  Steps are float32 0-d tensors on the
operand's device: dividing a CUDA tensor by a Python float would become a
multiply by the rounded reciprocal, which is not the reference's division.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import tree_map

# Paper §5.1 constants.
STEP_SIZE_UNI = 4.88e-4
STEP_SIZE_BI = 2.44e-4
STEP_SIZE_FINE = 2.38e-6


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """``step_size`` for weight tensors, ``fine_step_size`` for the leaves
    a fine mask marks (biases, norm parameters)."""

    step_size: float = STEP_SIZE_UNI
    fine_step_size: float = STEP_SIZE_FINE
    max_level: int = 2**23

    def step_for(self, is_fine: bool) -> float:
        return self.fine_step_size if is_fine else self.step_size


_F32: dict[tuple[float, torch.device], torch.Tensor] = {}


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-d tensor on ``like``'s device, made once
    per value and device (a host-to-device copy waits for the stream);
    callers only read it."""
    key = (value, like.device)
    t = _F32.get(key)
    if t is None:
        t = _F32[key] = torch.tensor(value, dtype=torch.float32,
                                     device=like.device)
    return t


def step_like(value: float, x: torch.Tensor) -> torch.Tensor:
    """The step a division of ``x`` by ``value`` uses: float32 for a
    float32 ``x`` (``f32``), ``value`` in ``x``'s own type for a wider one,
    as the reference's Python-float step divides a float64 array under
    ``jax.enable_x64``."""
    if x.dtype == torch.float32:
        return f32(value, x)
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def quantize(x: torch.Tensor, step_size: float,
             max_level: int = 2**23) -> torch.Tensor:
    """Float tensor -> int32 quantization levels (round half to even)."""
    q = torch.round(x / step_like(step_size, x))
    return torch.clamp(q, -max_level, max_level).to(torch.int32)


def dequantize(q: torch.Tensor, step_size: float) -> torch.Tensor:
    """float32 whatever the levels came from, as the reference's."""
    return q.to(torch.float32) * f32(step_size, q)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> ``(q, scale)``, int8
    ``q`` with ``x ~= q * scale``.  Without ``scale`` it is the max-abs
    over 127, a float32 0-d tensor on ``x``'s device (1 for a zero tensor,
    so no 0/0)."""
    if scale is None:
        amax = torch.max(torch.abs(x))
        scale = torch.where(amax > 0, amax / f32(127.0, amax),
                            f32(1.0, amax)).to(torch.float32)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _mask_or_false(tree: Any, fine_mask: Any | None) -> Any:
    return tree_map(lambda _: False, tree) if fine_mask is None else fine_mask


def quantize_tree(tree: Any, cfg: QuantConfig,
                  fine_mask: Any | None = None) -> Any:
    return tree_map(lambda x, f: quantize(x, cfg.step_for(f), cfg.max_level),
                    tree, _mask_or_false(tree, fine_mask))


def dequantize_tree(tree: Any, cfg: QuantConfig,
                    fine_mask: Any | None = None) -> Any:
    return tree_map(lambda q, f: dequantize(q, cfg.step_for(f)),
                    tree, _mask_or_false(tree, fine_mask))
