"""Server optimizers over aggregated client deltas (FedOpt).

Port of ``repro.fl.server_opt``.  The aggregated delta is a pseudo-gradient
``-delta`` for a first-order optimizer of ``repro_torch.optim``:

  fedavg      sgd(lr, momentum=0)      -> params + lr * delta
  fedavgm     sgd(lr, momentum)        -> momentum-smoothed delta
  fedadam     adam(lr, b1, b2, eps)    -> adaptive per-coordinate step
  fedyogi     yogi(lr, b1, b2, eps)    -> Yogi's additive v-control
  fedadagrad  adagrad(lr, eps)         -> accumulated-g^2 decay

FedAvg with lr = 1 adds the mean delta exactly.  The adaptive servers use
FedOpt's large-tau defaults (``b2 = 0.99``, ``eps = 1e-3``), not the client
Adam's.  The optimizer state lives in ``rounds.ServerStep`` and persists
across rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.optim import (Optimizer, adagrad, adam, apply_updates, sgd,
                               yogi)
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ServerOptConfig:
    name: str = "fedavg"     # fedavg | fedavgm | fedadam | fedyogi | fedadagrad
    lr: float = 1.0
    momentum: float = 0.9    # fedavgm
    b1: float = 0.9          # fedadam / fedyogi
    b2: float = 0.99         # fedadam / fedyogi (FedOpt's, not 0.999)
    eps: float = 1e-3        # "tau": FedOpt's large eps


def make_server_opt(cfg: ServerOptConfig) -> Optimizer:
    if cfg.name == "fedavg":
        return sgd(cfg.lr, momentum=0.0)
    if cfg.name == "fedavgm":
        return sgd(cfg.lr, momentum=cfg.momentum)
    if cfg.name == "fedadam":
        return adam(cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps)
    if cfg.name == "fedyogi":
        return yogi(cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps)
    if cfg.name == "fedadagrad":
        return adagrad(cfg.lr, eps=cfg.eps)
    raise ValueError(f"unknown server optimizer: {cfg.name!r}")


def server_update(opt: Optimizer, opt_state: Any, mean_delta: Any,
                  params: Any = None) -> tuple[Any, Any]:
    """One server-optimizer step -> (updates to add, new state)."""
    return opt.update(tree_map(torch.neg, mean_delta), opt_state, params)


def server_step(opt: Optimizer, params: Any, opt_state: Any,
                mean_delta: Any) -> tuple[Any, Any]:
    """Apply one server-optimizer step -> (new params, new state)."""
    updates, opt_state = server_update(opt, opt_state, mean_delta, params)
    return apply_updates(params, updates), opt_state
