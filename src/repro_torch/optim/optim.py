"""Functional optimizers in the reference's own form (not ``torch.optim``).

Port of ``repro.optim.optim``: ``opt = adam(lr); state = opt.init(params);
updates, state = opt.update(grads, state)``, with updates *added* to the
params.  Learning rates may be schedules (callables of the int32 step
tensor), read at the pre-increment step.  A cohort's state (the batched
client round) has one step a client, a (K,) tensor, and every leaf leads
with K: the rate and the bias corrections broadcast per client over each
leaf's leading axis (``tree.per_row``), the same float32 operations as a
client's own.  Adam and Yogi are bias-corrected
as ``-lr * (m / bc1) / (sqrt(v / bc2) + eps)``, evaluated in float32 in the
reference's operation order; Yogi moves ``v`` by
``v - (1 - b2) * sign(v - g*g) * g * g``, Adagrad accumulates ``g*g``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.tree import leaves, per_row, tree_map

Schedule = Callable[[torch.Tensor], torch.Tensor]
LR = Union[float, Schedule]


def _lr_at(lr: LR, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step).to(torch.float32)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)



def _device_of(params: Any) -> torch.device:
    ls = leaves(params)
    return ls[0].device if ls else torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


def sgd(lr: LR, momentum: float = 0.0) -> Optimizer:
    def init(params):
        mom = tree_map(torch.zeros_like, params) if momentum else None
        return SGDState(torch.zeros((), dtype=torch.int32,
                                    device=_device_of(params)), mom)

    def update(grads, state, params=None):
        del params
        lr_t = _lr_at(lr, state.step)
        if momentum:
            new_m = tree_map(lambda m, g: momentum * m + g,
                             state.momentum, grads)
            updates = tree_map(lambda m: -per_row(lr_t, m) * m, new_m)
        else:
            new_m = None
            updates = tree_map(lambda g: -per_row(lr_t, g) * g, grads)
        return updates, SGDState(state.step + 1, new_m)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def _bias_corrected(lr_t, b1: float, b2: float, step, mu, nu, eps):
    """``-lr * (m / bc1) / (sqrt(v / bc2) + eps)`` with ``bc = 1 - b**step``
    taken by a float32 ``pow`` on the step's device."""
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    return tree_map(
        lambda m, v: -per_row(lr_t, m) * (m / per_row(bc1, m)) / (
            torch.sqrt(v / per_row(bc2, v)) + eps),
        mu, nu)


def _moments0(params) -> AdamState:
    return AdamState(
        torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        tree_map(torch.zeros_like, params),
        tree_map(torch.zeros_like, params))


def adam(lr: LR, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def update(grads, state, params=None):
        del params
        step = state.step + 1
        lr_t = _lr_at(lr, state.step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        return (_bias_corrected(lr_t, b1, b2, step, mu, nu, eps),
                AdamState(step, mu, nu))

    return Optimizer(_moments0, update)


def yogi(lr: LR, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Yogi: Adam whose ``v`` moves toward ``g*g`` by a bounded additive
    step, so the effective lr can grow again after large gradients."""
    def update(grads, state, params=None):
        del params
        step = state.step + 1
        lr_t = _lr_at(lr, state.step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(
            lambda v, g: v - (1 - b2) * torch.sign(v - g * g) * g * g,
            state.nu, grads)
        return (_bias_corrected(lr_t, b1, b2, step, mu, nu, eps),
                AdamState(step, mu, nu))

    return Optimizer(_moments0, update)


class AdagradState(NamedTuple):
    step: torch.Tensor
    nu: Any


def adagrad(lr: LR, eps: float = 1e-8) -> Optimizer:
    """Adagrad: a per-coordinate lr decayed by the running sum of g*g."""
    def init(params):
        return AdagradState(
            torch.zeros((), dtype=torch.int32, device=_device_of(params)),
            tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        del params
        lr_t = _lr_at(lr, state.step)
        nu = tree_map(lambda v, g: v + g * g, state.nu, grads)
        updates = tree_map(
            lambda g, v: -per_row(lr_t, g) * g / (torch.sqrt(v) + eps),
            grads, nu)
        return updates, AdagradState(state.step + 1, nu)

    return Optimizer(init, update)


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over the leaves of their float32 squares, summed
    leaf after leaf."""
    total = sum(torch.sum(torch.square(x.to(torch.float32)))
                for x in leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Any, max_norm: float) -> Any:
    norm = global_norm(grads)
    # a tensor divided by a tensor: ``float / tensor`` would multiply by
    # the reciprocal
    top = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
    scale = torch.clamp(top / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads)
