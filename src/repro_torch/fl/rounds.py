"""Round-lifecycle stages: the paper's Algorithm 1 as composable objects.

Port of ``repro.fl.rounds`` (sync scheduling, gather ingest, no downlink
compression):

    CohortPlan -> LocalTrain -> Uplink -> Aggregate -> ServerStep -> Evaluate

``Uplink`` puts every cohort member's update on the wire and aggregates
only what decodes: per client through ``Codec.encode_batch`` (for
``int8-blockscale`` one kernel launch per client; the level codecs take
the cohort's levels to the host first), or, under
``EngineConfig.device_encode``, through ``Codec.encode_cohort`` (one
device program and one device-to-host copy per cohort).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import comms
from repro_torch.core import delta as delta_lib
from repro_torch.core.protocol import ProtocolConfig, ServerState
from repro_torch.data.federated import client_epoch_batches
from repro_torch.fl.executors import ClientExecutor
from repro_torch.fl.sampling import (EmptyCohortError, SamplingConfig,
                                     sample_cohort)
from repro_torch.fl.server_opt import server_update
from repro_torch.optim import apply_updates
from repro_torch.tree import row, tree_map

# ---------------------------------------------------------------- tree utils


def tree_mean0(tree: Any) -> Any:
    """Mean over the leading (client) axis."""
    return tree_map(lambda x: torch.mean(x, dim=0), tree)


def stack_trees(trees: list[Any], device: torch.device) -> Any:
    """Stack per-client trees (tensors or decoded numpy) on ``device``."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.tensor(x, device=device)  # decoded, read-only numpy

    return tree_map(lambda *ls: torch.stack([leaf(x) for x in ls]), *trees)


# ---------------------------------------------------------------- contracts

@dataclasses.dataclass
class Contribution:
    """One decoded client message plus its metadata."""
    client: int
    delta_params: Any
    delta_scales: Any
    bn_state: Any
    payload_bytes: int = 0
    metrics: dict[str, float] | None = None


@dataclasses.dataclass
class AggregatedRound:
    delta_params: Any
    delta_scales: Any
    bn_state: Any


@dataclasses.dataclass
class RoundIntake:
    """A scheduler's hand-off for ONE aggregation: every charged upload,
    and the indices of those that aggregate."""
    contributions: list[Contribution]
    survivors: list[int]


# ---------------------------------------------------------------- cohort plan

class CohortPlan:
    """Stage 1: who participates (materialized uniform draws)."""

    def __init__(self, sampling: SamplingConfig, num_clients: int):
        self.sampling = sampling
        self.num_clients = num_clients
        self.full = sampling.is_full(num_clients)

    def select(self, gen: torch.Generator) -> np.ndarray:
        if self.full:
            return np.arange(self.num_clients)
        return sample_cohort(gen, self.num_clients, self.sampling)


# ---------------------------------------------------------------- local train

class LocalTrain:
    """Stage 2: run ``client_round`` over a cohort.

    Per-client persistent state is one client-stacked tree on the device
    (the reference's in-memory store): the single-client template is
    repeated over the clients, gathered by cohort index before the round
    and scattered back after it."""

    def __init__(self, client_round, splits, persistent0, num_clients: int,
                 batch_size: int, executor: ClientExecutor):
        self.executor = executor
        self.executor.bind(client_round)
        self.splits = splits
        self.batch_size = batch_size
        self.n_train = splits.n_train
        self.state = tree_map(
            lambda x: x.expand((num_clients,) + tuple(x.shape)).clone(),
            persistent0)

    def batches(self, gen: torch.Generator, k: int) -> torch.Tensor:
        return client_epoch_batches(gen, k, self.n_train, self.batch_size)

    def train_cohort(self, idx: np.ndarray, batch_idx: torch.Tensor,
                     server: ServerState):
        """One barrier round over the cohort ``idx`` -> stacked RoundOutput."""
        if len(idx) == 0:
            raise EmptyCohortError("train_cohort received an empty cohort")
        dev = self.splits.client_x.device
        sel = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=dev)
        s = self.splits
        pers = tree_map(lambda x: x[sel], self.state)
        out = self.executor.run_shared(
            server, pers, s.client_x[sel], s.client_y[sel],
            s.client_val_x[sel], s.client_val_y[sel], batch_idx.to(dev))

        def scatter(full, rows):
            full[sel] = rows
            return full

        self.state = tree_map(scatter, self.state, out.persistent)
        return out


# ---------------------------------------------------------------- uplink

class Uplink:
    """Stage 3: the wire.  Encode each participant's update, decode it back;
    the engine aggregates the DECODED reconstructions, so ``payload_bytes``
    are lengths of payloads that provably decode."""

    def __init__(self, cfg: ProtocolConfig, engine_cfg, server: ServerState):
        self.transmit = engine_cfg.measure_bytes
        self.codec = comms.resolve_codec(engine_cfg.codec, cfg.quantize)
        self.spec = comms.WireSpec(
            params=comms.shape_template(server.params),
            scales=comms.shape_template(server.scales),
            fine_mask=comms.path_fine_mask(server.params),
            step_size=cfg.step_size,
            fine_step_size=cfg.fine_step_size,
            ternary=(cfg.method == "ternary"))
        self.device_encode = engine_cfg.device_encode

    def _metric_rows(self, out, k: int) -> list[dict[str, float]]:
        host = {name: v.detach().cpu().numpy() for name, v in
                out.metrics.items()}
        return [{name: float(v[i]) for name, v in host.items()}
                for i in range(k)]

    def intake(self, out, clients: list[int]) -> list[Contribution]:
        """Stacked cohort RoundOutput -> one Contribution per client."""
        k = len(clients)
        metrics = self._metric_rows(out, k)
        if not self.transmit:
            return [Contribution(
                client=c, delta_params=row(out.recon_delta_params, i),
                delta_scales=row(out.recon_delta_scales, i),
                bn_state=row(out.bn_state, i), metrics=metrics[i])
                for i, c in enumerate(clients)]
        payloads = None
        if self.device_encode:
            payloads = self.codec.encode_cohort(out, self.spec,
                                                clients=clients)
        if payloads is None:
            lv_p, lv_s = out.levels_params, out.levels_scales
            if "levels" in self.codec.needs:   # host coders read numpy
                lv_p, lv_s = tree_map(torch.Tensor.cpu, (lv_p, lv_s))
            payloads = self.codec.encode_batch([comms.ClientUpdate(
                row(lv_p, i), row(lv_s, i), row(out.recon_delta_params, i),
                row(out.recon_delta_scales, i)) for i in range(k)],
                self.spec, clients=clients)
        decs = self.codec.decode_batch(payloads, self.spec, clients=clients)
        return [Contribution(
            client=c, delta_params=dec.params, delta_scales=dec.scales,
            bn_state=row(out.bn_state, i), payload_bytes=len(p),
            metrics=metrics[i])
            for i, (c, p, dec) in enumerate(zip(clients, payloads, decs))]


# ---------------------------------------------------------------- aggregate

class Aggregate:
    """Stage 4: the plain mean of the survivors' contributions."""

    def __init__(self, device: torch.device):
        self.device = device

    def __call__(self, contribs: list[Contribution]) -> AggregatedRound:
        if not contribs:
            raise ValueError("cannot aggregate zero contributions")

        def mean(trees):
            return tree_mean0(stack_trees(trees, self.device))

        return AggregatedRound(
            delta_params=mean([c.delta_params for c in contribs]),
            delta_scales=mean([c.delta_scales for c in contribs]),
            bn_state=mean([c.bn_state for c in contribs]))


# ---------------------------------------------------------------- server step

class ServerStep:
    """Stage 5: fold one AggregatedRound into the server state.  The
    broadcast is not compressed (the reference's inactive Downlink)."""

    def __init__(self, opt):
        self.opt = opt
        self.state = None

    def init(self, params: Any) -> None:
        self.state = self.opt.init(params)

    def __call__(self, server: ServerState,
                 agg: AggregatedRound) -> ServerState:
        updates, self.state = server_update(self.opt, self.state,
                                            agg.delta_params, server.params)
        return ServerState(
            params=apply_updates(server.params, updates),
            scales=delta_lib.tree_add(server.scales, agg.delta_scales),
            bn_state=agg.bn_state)


# ---------------------------------------------------------------- evaluate

class Evaluate:
    """Stage 7: server-side test accuracy."""

    def __init__(self, evaluate_fn, test_x, test_y):
        self._eval = evaluate_fn
        self.test_x, self.test_y = test_x, test_y

    def __call__(self, server: ServerState) -> float:
        return float(self._eval(server, self.test_x, self.test_y))


# ---------------------------------------------------------------- scheduler

class SyncScheduler:
    """Cohort barrier: one cohort per aggregation, everyone against the
    same server snapshot.

    Cohorts and batch orders come from the scheduler's ``torch.Generator``,
    or, for runs held against the reference, from ``plan``: one
    ``(cohort indices, (K, steps, batch) batch indices)`` pair per round,
    as numpy arrays."""

    def bind(self, engine, gen: torch.Generator, plan=None) -> None:
        self.eng = engine
        self.gen = gen
        self.plan = None if plan is None else list(plan)
        self.round_idx = 0

    def next_round(self) -> RoundIntake:
        eng = self.eng
        self.round_idx += 1
        if self.plan is not None:
            if self.round_idx > len(self.plan):
                raise ValueError(f"the plan covers {len(self.plan)} rounds; "
                                 f"round {self.round_idx} was asked for")
            idx, bidx = self.plan[self.round_idx - 1]
            idx = np.asarray(idx)
            bidx = torch.tensor(np.asarray(bidx), dtype=torch.long)
        else:
            idx = eng.cohort.select(self.gen)
            bidx = eng.local_train.batches(self.gen, len(idx))
        clients = [int(c) for c in idx]
        out = eng.local_train.train_cohort(idx, bidx, eng.server)
        contribs = eng.uplink.intake(out, clients)
        return RoundIntake(contribs, list(range(len(clients))))

    def log_line(self, rec, intake: RoundIntake) -> str:
        return (f"round {rec.round:3d} acc={rec.test_acc:.3f} "
                f"cohort={len(intake.survivors)}/{len(intake.contributions)} "
                f"up={rec.up_bytes / 1e6:.3f}MB "
                f"sparsity={rec.update_sparsity:.3f}")


SCHEDULERS = {"sync": SyncScheduler}
