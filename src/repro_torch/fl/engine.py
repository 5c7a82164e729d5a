"""Federated simulation engine: one orchestrator, scheduling as policy.

Port of ``repro.fl.engine`` for the sync scheduler.  ``FederatedEngine``
builds one instance of each ``repro_torch.fl.rounds`` stage and asks the
scheduler for one ``RoundIntake`` per aggregation, which it folds through
``Aggregate -> ServerStep (-> Downlink) -> Evaluate``.  With
``EngineConfig.bidirectional`` the server's update is compressed and put
on the wire before it is applied (§5.2), and ``down_bytes`` counts it.
``EngineConfig.channel`` turns payload lengths into simulated seconds
(``RoundRecord.sim_time_s``) and drops uploads; ``up_predicate`` keeps
the leaves it rejects off the wire (partial updates); ``wire_schema=2``
puts the clients' BN statistics inside every payload.

Randomness: standalone runs draw the initial state, cohorts and batch
orders from one ``torch.Generator`` seeded with ``seed``.  Runs held
against the reference pass ``init_state`` (the reference's initial
``ServerState``/``ClientPersistent`` through ``repro_torch.convert``) and
``plan`` (its per-round cohorts and batch indices) instead.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.coding import nnc
from repro_torch.comms.channel import ChannelConfig, ChannelModel
from repro_torch.core import quant as quant_lib
from repro_torch.core.protocol import ProtocolConfig, make_protocol
from repro_torch.data.federated import FederatedSplits
from repro_torch.fl.executors import EXECUTORS, make_executor
from repro_torch.fl.rounds import (SCHEDULERS, Aggregate, CohortPlan,
                                   Downlink, Evaluate, LocalTrain,
                                   RoundIntake, ServerStep, Uplink,
                                   raw_bytes_per_client)
from repro_torch.fl.sampling import SamplingConfig
from repro_torch.fl.server_opt import ServerOptConfig, make_server_opt
from repro_torch.runtime import not_ported, resolve_device
from repro_torch.tree import leaves, row, tree_map


@dataclasses.dataclass
class RoundRecord:
    round: int
    test_acc: float
    up_bytes: int
    down_bytes: int
    cum_bytes: int
    mean_val_acc: float
    update_sparsity: float
    train_loss: float
    wall_s: float
    participants: tuple[int, ...] = ()
    sim_time_s: float = 0.0   # simulated clock (with a channel; else 0)


@dataclasses.dataclass
class RunResult:
    config_name: str
    records: list[RoundRecord]
    server: Any = None   # final ServerState

    @property
    def final_acc(self) -> float:
        """Last round's test accuracy; NaN when no rounds ran."""
        if not self.records:
            return float("nan")
        return self.records[-1].test_acc

    def rounds_to_acc(self, target: float) -> int | None:
        """The first round whose test accuracy reaches ``target``."""
        for r in self.records:
            if r.test_acc >= target:
                return r.round
        return None

    def bytes_to_acc(self, target: float) -> int | None:
        """Cumulative bytes up to the first round that reaches
        ``target``."""
        for r in self.records:
            if r.test_acc >= target:
                return r.cum_bytes
        return None

    def metric_series(self, name: str) -> list[tuple[int, float]]:
        """(round, value) pairs for a RoundRecord field, skipping rounds
        where the metric is absent (None or NaN), as after an all-drop
        round."""
        out = []
        for r in self.records:
            v = getattr(r, name, None)
            if v is None or (isinstance(v, float) and np.isnan(v)):
                continue
            out.append((r.round, float(v)))
        return out

    def mean_metric(self, name: str) -> float:
        """Run-level mean of a RoundRecord field over the rounds that carry
        it; NaN when no round does."""
        vals = [v for _, v in self.metric_series(name)]
        return float(np.mean(vals)) if vals else float("nan")


# fields of the reference's EngineConfig that the port does not run yet,
# with their defaults and the port-queue item that will bring them
_NOT_PORTED_FIELDS = {
    "uplink_workers": (0, "streaming ingest, population, telemetry"),
    "uplink_batch": (False, "streaming ingest, population, telemetry"),
    "ingest": ("gather", "streaming ingest, population, telemetry"),
    "population": (None, "streaming ingest, population, telemetry"),
    "telemetry": ("off", "streaming ingest, population, telemetry"),
    "mesh_shape": (None, "executors: vmap, sharded, dist"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)
    server_opt: ServerOptConfig = dataclasses.field(
        default_factory=ServerOptConfig)
    mode: str = "sync"
    bidirectional: bool = False
    down_step_size: float = quant_lib.STEP_SIZE_BI
    measure_bytes: bool = True           # real wire round trips
    codec: Any = "auto"                  # registry name | comms.Codec
    wire_schema: int = 1
    device_encode: bool = False          # cohort encode on the device
    executor: str = "serial"
    channel: ChannelConfig | None = None
    up_predicate: Callable | None = None  # wire leaf predicate (partial)
    # accepted only at the reference's defaults (not ported yet)
    uplink_workers: int = 0
    uplink_batch: bool = False
    ingest: str = "gather"
    population: int | None = None
    telemetry: str = "off"
    mesh_shape: tuple[int, ...] | None = None

    def validate(self) -> None:
        for name, (default, item) in _NOT_PORTED_FIELDS.items():
            if getattr(self, name) != default:
                raise not_ported(f"EngineConfig.{name}={getattr(self, name)!r}",
                                 item)
        if self.mode == "async":
            raise not_ported("async scheduling", "async scheduling")
        if self.mode not in SCHEDULERS:
            raise ValueError(f"unknown engine mode: {self.mode!r}")
        if self.executor not in EXECUTORS:
            raise ValueError(f"unknown executor: {self.executor!r}")
        if self.channel is not None and not self.measure_bytes:
            raise ValueError("a channel model needs real payloads: "
                             "set measure_bytes=True")
        if self.wire_schema not in (1, 2):
            raise ValueError(
                f"unknown wire schema {self.wire_schema!r} (known: 1, 2)")
        if self.device_encode and not self.measure_bytes:
            raise ValueError("device_encode builds real payloads on device: "
                             "set measure_bytes=True")


# ------------------------------------------------------------- byte helpers

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def encode_client_bytes(levels_params: Any, levels_scales: Any,
                        ternary: bool) -> int:
    """DeepCABAC bytes of ONE client's update, as the reference accounts
    them: the ``{"p", "s"}`` level message, plus one float32 magnitude per
    params tensor for ternary updates."""
    msg = {"p": tree_map(_host, levels_params),
           "s": tree_map(_host, levels_scales)}
    n = len(nnc.encode_tree(msg))
    if ternary:
        n += 4 * len(leaves(levels_params))
    return n


def measure_update_bytes(levels_params: Any, levels_scales: Any,
                         num_clients: int, ternary: bool) -> int:
    """DeepCABAC bytes summed over client-stacked uploads."""
    return sum(encode_client_bytes(row(levels_params, i),
                                   row(levels_scales, i), ternary)
               for i in range(num_clients))


class FederatedEngine:
    """One engine = one stage pipeline + one scheduling policy."""

    def __init__(self, model, cfg: ProtocolConfig, splits: FederatedSplits,
                 *, seed: int = 42, engine_cfg: EngineConfig | None = None,
                 init_state=None, plan=None, device=None):
        engine_cfg = engine_cfg if engine_cfg is not None else EngineConfig()
        engine_cfg.validate()
        self.device = resolve_device(device)
        self.config_name = cfg.name
        self.protocol_cfg = cfg
        splits = splits.to(self.device)
        self.num_clients = splits.num_clients

        steps_per_round = max(1, splits.n_train // cfg.batch_size)
        init, client_round, evaluate = make_protocol(model, cfg,
                                                     steps_per_round)
        gen = torch.Generator().manual_seed(seed)
        if init_state is None:
            server, persistent0 = init(gen, self.device)
        else:
            server, persistent0 = init_state
        self.server = server

        self.cohort = CohortPlan(engine_cfg.sampling, self.num_clients)
        self.local_train = LocalTrain(
            client_round, splits, persistent0, self.num_clients,
            cfg.batch_size, make_executor(engine_cfg.executor))
        self.uplink = Uplink(cfg, engine_cfg, server)
        self.aggregate = Aggregate(self.device)
        self.server_step = ServerStep(make_server_opt(engine_cfg.server_opt))
        self.server_step.init(server.params)
        self.downlink = Downlink(cfg, engine_cfg.down_step_size,
                                 server.params, self.uplink.codec,
                                 engine_cfg.bidirectional)
        self.evaluate = Evaluate(evaluate, splits.test_x, splits.test_y)
        self.channel = (ChannelModel(engine_cfg.channel, self.num_clients)
                        if engine_cfg.channel is not None else None)
        self._raw_model_bytes = raw_bytes_per_client(server.params)
        self.scheduler = SCHEDULERS[engine_cfg.mode]()
        self.scheduler.bind(self, gen, plan)

    def broadcast_ref_bytes(self) -> int:
        """Bytes a client downloads before its round: the last compressed
        broadcast under bidirectional compression, else the raw float32
        model."""
        if self.downlink.active and self.downlink.last_payload_bytes:
            return self.downlink.last_payload_bytes
        return self._raw_model_bytes

    @staticmethod
    def _mean_metric(intake: RoundIntake, name: str) -> float:
        vals = [c.metrics[name] for c in intake.contributions
                if c.metrics is not None and name in c.metrics]
        return float(np.mean(vals)) if vals else float("nan")

    def run(self, rounds: int, *, verbose: bool = False) -> RunResult:
        records: list[RoundRecord] = []
        cum = 0
        with torch.no_grad():
            while len(records) < rounds:
                t0 = time.time()
                intake = self.scheduler.next_round()
                survivors = [intake.contributions[i]
                             for i in intake.survivors]
                up_bytes = sum(c.payload_bytes for c in intake.contributions)
                down_bytes = 0
                if survivors:
                    self.server, down_bytes = self.server_step(
                        self.server, self.aggregate(survivors),
                        self.downlink, intake.receivers,
                        self.uplink.transmit)
                cum += up_bytes + down_bytes
                acc = self.evaluate(self.server)
                rec = RoundRecord(
                    round=len(records) + 1, test_acc=acc, up_bytes=up_bytes,
                    down_bytes=down_bytes, cum_bytes=cum,
                    mean_val_acc=self._mean_metric(intake, "val_acc"),
                    update_sparsity=self._mean_metric(intake,
                                                      "update_sparsity"),
                    train_loss=self._mean_metric(intake, "train_loss"),
                    wall_s=time.time() - t0,
                    participants=tuple(c.client for c in survivors),
                    sim_time_s=intake.sim_time)
                records.append(rec)
                if verbose:
                    print(f"[{self.config_name}] "
                          + self.scheduler.log_line(rec, intake))
        return RunResult(self.config_name, records, server=self.server)


def run_simulation(model, cfg: ProtocolConfig, splits: FederatedSplits,
                   rounds: int, *, seed: int = 42,
                   engine: EngineConfig | None = None, init_state=None,
                   plan=None, device=None, verbose: bool = False) -> RunResult:
    """Run ``rounds`` aggregations of the federated simulation on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    return FederatedEngine(model, cfg, splits, seed=seed, engine_cfg=engine,
                           init_state=init_state, plan=plan,
                           device=device).run(rounds, verbose=verbose)
