"""Cohort execution backends: how a batch of ``client_round`` calls runs.

Port of ``repro.fl.executors`` (serial backend).  ``SerialExecutor`` runs
one ``client_round`` per client and stacks the outputs on a leading client
axis, the (K, ...) ``RoundOutput`` the uplink consumes: ``run_shared``
against one server snapshot (a sync cohort), ``run_stacked`` each row
against its own snapshot (an async dispatch window whose members started
from different server versions).  The reference's tests hold its serial
backend equal to the vmapped one within one quantization level.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.runtime import not_ported
from repro_torch.tree import row, tree_map


def _stack(outs: list[Any]) -> Any:
    return tree_map(lambda *ls: torch.stack(ls), *outs)


class ClientExecutor:
    """Bind ``client_round`` once, then run cohort batches."""

    name: str = "?"

    def bind(self, client_round) -> None:
        raise NotImplementedError

    def run_shared(self, server, pers, cx, cy, cvx, cvy, bidx):
        """Batch vs ONE server snapshot (sync cohort barrier)."""
        raise NotImplementedError

    def run_stacked(self, servers, pers, cx, cy, cvx, cvy, bidx):
        """Batch vs per-row server snapshots (``servers[i]`` for row i)."""
        raise NotImplementedError


class SerialExecutor(ClientExecutor):
    """One ``client_round`` per client, outputs stacked in cohort order."""

    name = "serial"

    def bind(self, client_round) -> None:
        self.round = client_round

    def run_shared(self, server, pers, cx, cy, cvx, cvy, bidx):
        return _stack([self.round(server, row(pers, i), cx[i], cy[i],
                                  cvx[i], cvy[i], bidx[i])
                       for i in range(cx.shape[0])])

    def run_stacked(self, servers, pers, cx, cy, cvx, cvy, bidx):
        return _stack([self.round(servers[i], row(pers, i), cx[i], cy[i],
                                  cvx[i], cvy[i], bidx[i])
                       for i in range(cx.shape[0])])


EXECUTORS = ("serial", "vmap", "sharded", "dist")


def make_executor(name: str) -> ClientExecutor:
    if name == "serial":
        return SerialExecutor()
    if name in EXECUTORS:
        raise not_ported(f"executor {name!r}",
                         "executors: vmap, sharded, dist")
    raise ValueError(f"unknown executor: {name!r} (known: "
                     f"{', '.join(EXECUTORS)})")
