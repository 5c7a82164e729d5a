"""Server optimizers over aggregated client deltas (FedOpt).

Port of ``repro.fl.server_opt`` (FedAvg).  The aggregated delta is a
pseudo-gradient ``-delta`` for a first-order optimizer; FedAvg is
``sgd(lr, momentum=0)``, and with lr = 1 it adds the mean delta exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.optim import Optimizer, sgd
from repro_torch.runtime import not_ported
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ServerOptConfig:
    name: str = "fedavg"
    lr: float = 1.0


def make_server_opt(cfg: ServerOptConfig) -> Optimizer:
    if cfg.name == "fedavg":
        return sgd(cfg.lr, momentum=0.0)
    if cfg.name in ("fedavgm", "fedadam", "fedyogi", "fedadagrad"):
        raise not_ported(f"server optimizer {cfg.name!r}",
                         "sampling and server optimizers")
    raise ValueError(f"unknown server optimizer: {cfg.name!r}")


def server_update(opt: Optimizer, opt_state: Any, mean_delta: Any,
                  params: Any = None) -> tuple[Any, Any]:
    """One server-optimizer step -> (updates to add, new state)."""
    return opt.update(tree_map(torch.neg, mean_delta), opt_state, params)
