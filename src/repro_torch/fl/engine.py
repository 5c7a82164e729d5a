"""Federated simulation engine: one orchestrator, scheduling as policy.

Port of ``repro.fl.engine`` for the sync and buffered-async schedulers.
``FederatedEngine`` builds one instance of each ``repro_torch.fl.rounds``
stage and asks the scheduler (``mode``) for one ``RoundIntake`` per
aggregation, which it folds through ``Aggregate -> ServerStep (->
Downlink) -> Evaluate``; the server's ``version`` counts the aggregations
that had survivors (async staleness is measured against it).  Cohorts may
be drawn uniformly or by weight (``SamplingConfig``), and the server
optimizer is any of FedAvg, FedAvgM, FedAdam, FedYogi and FedAdagrad
(``ServerOptConfig``), its state kept across rounds.  With
``EngineConfig.bidirectional`` the server's update is compressed and put
on the wire before it is applied (§5.2), and ``down_bytes`` counts it.
``EngineConfig.channel`` turns payload lengths into simulated seconds
(``RoundRecord.sim_time_s``) and drops uploads; ``up_predicate`` keeps
the leaves it rejects off the wire (partial updates); ``wire_schema=2``
puts the clients' BN statistics inside every payload.  The host uplink
may code the cohort on a thread or forkserver pool (``uplink_workers``,
``uplink_executor``, ``uplink_batch``), and ``ingest="streaming"`` folds
the decoded payloads into running accumulators (``fl.ingest``) instead
of gathering them.  ``telemetry`` (``"off" | "metrics" | "trace"``, the
port's ``obs``) records spans and per-round counters into
``RoundRecord.telemetry`` without changing a record, and ``metrics_out``
streams each round's snapshot to a JSONL file.

The population axis (``fl.population``): ``population`` virtual clients
over the splits' base shards (their data hashed onto the shards), their
persistent state in a client-state store (``store``: the device tree in
memory, or sharded on the host with spill-to-disk), cohorts streamed by a
hash draw, and a ``traffic`` model (diurnal availability, device-class
latencies, mid-round churn) gating the cohorts and driving the simulated
clock.  Async windows may be sized adaptively
(``AsyncConfig.adaptive_window``).  With ``executor="dist"`` in a
multi-process job (``repro_torch.dist``) the store is wrapped in a
``CrossHostClientStore``: each process keeps the clients its blocks
train, and a gather hands rows off between processes.

Randomness: standalone runs draw the initial state, cohorts, latencies
and batch orders from one ``torch.Generator`` seeded with ``seed``.  Runs
held against the reference pass ``init_state`` (the reference's initial
``ServerState``/``ClientPersistent`` through ``repro_torch.convert``) and
``plan`` (sync: its per-round cohorts and batch indices; async: a
``rounds.AsyncPlan``) instead.  Streamed cohorts and traffic draws are
hash functions of their seeds, the reference's ids in both packages.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.coding import nnc
from repro_torch.comms.channel import ChannelConfig, ChannelModel
from repro_torch.core import quant as quant_lib
from repro_torch.core.protocol import ProtocolConfig, make_protocol
from repro_torch.data.federated import FederatedSplits
from repro_torch.fl.async_buffer import AsyncConfig
from repro_torch.fl.executors import EXECUTORS, make_executor
from repro_torch.fl.ingest import IngestConfig, StreamingIngest
from repro_torch.fl.population import (StoreConfig, TrafficConfig,
                                       TrafficModel, make_store, make_view)
from repro_torch.fl.rounds import (SCHEDULERS, Aggregate, CohortPlan,
                                   Downlink, Evaluate, LocalTrain,
                                   RoundIntake, ServerStep, Uplink,
                                   raw_bytes_per_client)
from repro_torch.fl.sampling import SamplingConfig
from repro_torch.fl.server_opt import ServerOptConfig, make_server_opt
from repro_torch.launch.mesh import device_count
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import resolve_device
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
    sim_time_s: float = 0.0   # simulated clock (a channel or traffic; else 0)
    # the round's metrics snapshot (obs.MetricsRegistry.snapshot_round),
    # None with telemetry off; never part of a parity comparison
    telemetry: dict | None = None


@dataclasses.dataclass
class RunResult:
    config_name: str
    records: list[RoundRecord]
    server: Any = None   # final ServerState
    telemetry: Any = None  # the run's obs.Telemetry (trace export)

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


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)
    server_opt: ServerOptConfig = dataclasses.field(
        default_factory=ServerOptConfig)
    mode: str = "sync"                   # "sync" | "async"
    async_cfg: AsyncConfig = dataclasses.field(default_factory=AsyncConfig)
    bidirectional: bool = False
    down_step_size: float = quant_lib.STEP_SIZE_BI
    measure_bytes: bool = True           # real wire round trips
    codec: Any = "auto"                  # registry name | comms.Codec
    wire_schema: int = 1
    device_encode: bool = False          # cohort encode on the device
    # cohort backend (fl.executors): "vmap" runs the cohort in one batched
    # call, "serial" one client at a time, "sharded" the batched call in
    # blocks over a 1-D device mesh (mesh_shape; None: every visible device)
    executor: str = "vmap"
    mesh_shape: tuple[int, ...] | None = None
    channel: ChannelConfig | None = None
    up_predicate: Callable | None = None  # wire leaf predicate (partial)
    uplink_workers: int = 0              # > 1: a pool of wire round trips
    uplink_executor: str = "thread"      # "thread" | "process"
    uplink_batch: bool = False           # batch API: <= workers pool tasks
    # "gather" decodes every payload and averages the list; "streaming"
    # folds each decoded payload into running accumulators (fl.ingest)
    ingest: str = "gather"
    ingest_opts: IngestConfig = dataclasses.field(
        default_factory=IngestConfig)
    # the population axes (fl.population)
    population: int | None = None        # virtual clients (None: splits')
    store: StoreConfig = dataclasses.field(default_factory=StoreConfig)
    traffic: TrafficConfig | None = None  # trace-driven arrivals, churn
    telemetry: str = "off"               # "off" | "metrics" | "trace"
    metrics_out: str | None = None       # per-round snapshot JSONL stream

    def validate(self, num_clients: int | None = None) -> None:
        if self.mode not in SCHEDULERS:
            raise ValueError(f"unknown engine mode: {self.mode!r}")
        if self.executor not in EXECUTORS:
            raise ValueError(f"unknown executor: {self.executor!r}")
        if self.mesh_shape is not None:
            if self.executor != "sharded":
                raise ValueError(
                    f"mesh_shape configures the sharded cohort mesh; it has "
                    f"no meaning for executor={self.executor!r}: drop it or "
                    "set executor='sharded' (the 'dist' backend builds its "
                    "mesh from the torch.distributed process topology)")
            if len(self.mesh_shape) != 1 or self.mesh_shape[0] < 1:
                raise ValueError(
                    f"mesh_shape must be a 1-D positive shape (the cohort "
                    f"axis is the only sharded axis), got {self.mesh_shape!r}")
            need, have = self.mesh_shape[0], device_count()
            if need > have:
                raise ValueError(
                    f"mesh_shape {self.mesh_shape!r} needs {need} devices "
                    f"but only {have} are visible")
        if self.sampling.strategy == "weighted":
            w = self.sampling.weights
            if w is None or (num_clients is not None
                             and len(w) != num_clients):
                raise ValueError(
                    "weighted sampling needs one weight per client")
        if self.channel is not None and not self.measure_bytes:
            raise ValueError("a channel model needs real payloads: "
                             "set measure_bytes=True")
        if (self.channel is not None and self.channel.drop_rate > 0.0
                and self.mode == "async"):
            raise ValueError("ChannelConfig.drop_rate models sync-round "
                             "upload loss only; async mode does not "
                             "implement drops")
        if self.mode == "async" and self.sampling.cohort_size is not None:
            raise ValueError(
                "async mode has no per-round cohort: participation is driven "
                "by AsyncConfig.concurrency; leave SamplingConfig.cohort_size "
                "unset")
        if self.async_cfg.dispatch_window < 0.0:
            raise ValueError("AsyncConfig.dispatch_window must be >= 0 "
                             "(simulated seconds)")
        if self.mode != "async" and self.async_cfg.dispatch_window > 0.0:
            raise ValueError(
                "AsyncConfig.dispatch_window batches concurrently-finishing "
                "async completions; it has no meaning for mode="
                f"{self.mode!r} — drop it or set mode='async'")
        if self.wire_schema not in (1, 2):
            raise ValueError(
                f"unknown wire schema {self.wire_schema!r} (known: 1, 2)")
        if self.device_encode and not self.measure_bytes:
            raise ValueError("device_encode builds real payloads on device: "
                             "set measure_bytes=True")
        if (self.mode == "async" and self.uplink_workers > 1
                and self.async_cfg.dispatch_window <= 0.0
                and not self.async_cfg.adaptive_window):
            raise ValueError(
                "uplink_workers parallelises a batch of wire round-trips; "
                "with dispatch_window=0 the async scheduler transmits one "
                "completion at a time, so a pool would be a silent no-op — "
                "set AsyncConfig.dispatch_window > 0 or adaptive_window "
                "(window batches flow through the pooled intake) or leave "
                "uplink_workers unset")
        if self.async_cfg.adaptive_window:
            if self.mode != "async":
                raise ValueError(
                    "AsyncConfig.adaptive_window sizes async dispatch "
                    f"batches; it has no meaning for mode={self.mode!r}")
            if self.async_cfg.dispatch_window > 0.0:
                raise ValueError(
                    "adaptive_window and a fixed dispatch_window are "
                    "mutually exclusive — drop one")
            cs = self.async_cfg.call_saving_s
            if cs is not None and cs < 0.0:
                raise ValueError("AsyncConfig.call_saving_s must be >= 0 "
                                 "(simulated seconds per merged call)")
        if self.population is not None:
            if self.population < 1:
                raise ValueError(
                    f"population must be >= 1, got {self.population}")
            if self.mode == "sync" and self.sampling.cohort_size is None:
                raise ValueError(
                    "a population axis means full participation would "
                    "materialize every virtual client — set "
                    "SamplingConfig.cohort_size (K << population)")
        self.store.validate()
        if self.traffic is not None:
            self.traffic.validate()
        if self.uplink_executor not in ("thread", "process"):
            raise ValueError("uplink_executor must be 'thread' or 'process', "
                             f"got {self.uplink_executor!r}")
        if self.uplink_workers < 0:
            raise ValueError("uplink_workers must be >= 0")
        if self.ingest not in ("gather", "streaming"):
            raise ValueError(f"unknown ingest mode: {self.ingest!r} "
                             "(known: gather, streaming)")
        if self.ingest == "streaming":
            if not self.measure_bytes:
                raise ValueError(
                    "streaming ingest decodes real payloads; set "
                    "measure_bytes=True or use ingest='gather'")
            if self.uplink_workers > 1:
                raise ValueError(
                    "uplink_workers pools the gather encode+decode round "
                    "trip; with ingest='streaming' decode parallelism lives "
                    "in IngestConfig.workers: drop uplink_workers or use "
                    "ingest='gather'")
            self.ingest_opts.validate()
        elif self.ingest_opts != IngestConfig():
            raise ValueError(
                "ingest_opts configures the streaming ingest stage; it has "
                f"no meaning for ingest={self.ingest!r}: drop it or set "
                "ingest='streaming'")
        if self.telemetry not in obs.TELEMETRY_MODES:
            known = ", ".join(obs.TELEMETRY_MODES)
            raise ValueError(f"unknown telemetry mode: {self.telemetry!r} "
                             f"(known: {known})")
        if self.metrics_out is not None and self.telemetry == "off":
            raise ValueError("metrics_out streams per-round snapshots; it "
                             "needs telemetry='metrics' or 'trace'")


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
        num_clients = (engine_cfg.population
                       if engine_cfg.population is not None
                       else splits.num_clients)
        engine_cfg.validate(num_clients)
        self.device = resolve_device(device)
        self.config_name = cfg.name
        self.protocol_cfg = cfg
        splits = splits.to(self.device)
        self.num_clients = num_clients

        steps_per_round = max(1, splits.n_train // cfg.batch_size)
        init, client_round, evaluate = make_protocol(model, cfg,
                                                     steps_per_round)
        gen = torch.Generator().manual_seed(seed)
        if init_state is None:
            server, persistent0 = init(gen, self.device)
        else:
            server, persistent0 = init_state
        self.server = server
        self.version = 0    # aggregations with survivors (async staleness)
        self.async_cfg = engine_cfg.async_cfg
        self.engine_cfg = engine_cfg
        self.traffic = (TrafficModel(engine_cfg.traffic)
                        if engine_cfg.traffic is not None else None)
        # the run's span recorder and metrics registry, ambient for the
        # duration of run() (off: the shared no-op bundle)
        self.telemetry = obs.make_telemetry(
            engine_cfg.telemetry, metrics_out=engine_cfg.metrics_out)

        # the population axes: per-client state in a store, data through a
        # view (the splits, or virtual clients hashed onto them), and
        # streamed cohorts with a population or a traffic model
        self.cohort = CohortPlan(
            engine_cfg.sampling, self.num_clients,
            streaming=engine_cfg.population is not None,
            traffic=self.traffic)
        executor = make_executor(engine_cfg.executor,
                                 mesh_shape=engine_cfg.mesh_shape,
                                 device=self.device)
        store = make_store(engine_cfg.store, persistent0, self.num_clients)
        if (engine_cfg.executor == "dist"
                and executor.ctx.process_count > 1):
            # a multi-process mesh: each process keeps the state of the
            # clients its blocks train, handed off between processes when
            # sampling moves a client (repro_torch.dist.state)
            from repro_torch.dist import CrossHostClientStore
            store = CrossHostClientStore(store, executor.ctx,
                                         executor.position_owners,
                                         template=persistent0)
        self.local_train = LocalTrain(
            client_round,
            make_view(splits, engine_cfg.population,
                      seed=engine_cfg.sampling.stream_seed),
            store, cfg.batch_size, executor)
        self.uplink = Uplink(cfg, engine_cfg, server)
        self.aggregate = Aggregate(self.device, engine_cfg.measure_bytes,
                                   engine_cfg.wire_schema == 2)
        self.server_step = ServerStep(make_server_opt(engine_cfg.server_opt))
        self.server_step.init(server.params)
        self.downlink = Downlink(cfg, engine_cfg.down_step_size,
                                 server.params, self.uplink.codec,
                                 engine_cfg.bidirectional)
        self.evaluate = Evaluate(evaluate, splits.test_x, splits.test_y)
        self.channel = (ChannelModel(engine_cfg.channel, self.num_clients)
                        if engine_cfg.channel is not None else None)
        self._raw_model_bytes = raw_bytes_per_client(server.params)
        self.streaming_ingest = engine_cfg.ingest == "streaming"
        if self.streaming_ingest:
            # an unsupported codec and decode engine fail here, not
            # mid-round
            self._ingest_codec = self.uplink.codec.with_decode_engine(
                engine_cfg.ingest_opts.decode_engine)
        self.scheduler = SCHEDULERS[engine_cfg.mode]()
        self.scheduler.bind(self, gen, plan)

    def make_ingest(self) -> StreamingIngest:
        """A fresh single-use streaming ingest on the uplink's wire spec,
        its sums on the engine's device (one an aggregation)."""
        return StreamingIngest(self._ingest_codec, self.uplink.spec,
                               self.engine_cfg.ingest_opts, self.device)

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

    def _record_round_metrics(self, rec: RoundRecord, intake: RoundIntake,
                              run_t0: float) -> None:
        """The round's registry updates, from the values of its record:
        the snapshot's byte counters equal ``up_bytes``/``down_bytes``."""
        m = self.telemetry.metrics
        m.count("uplink.bytes", rec.up_bytes)
        m.count("downlink.bytes", rec.down_bytes)
        m.count("rounds", 1)
        m.gauge("round.wall_s", rec.wall_s)
        m.gauge("round.sim_time_s", rec.sim_time_s)
        # how far the simulated clock runs ahead of the wall clock
        m.gauge("clock.skew_s", rec.sim_time_s - (time.time() - run_t0))
        m.gauge("round.cohort", len(intake.contributions))
        m.gauge("round.survivors", len(intake.survivors))
        m.gauge("uplink.pool_tasks", self.uplink.pool_tasks)
        for k, v in self.local_train.store.stats().items():
            m.gauge(f"store.{k}", v)

    def run(self, rounds: int, *, verbose: bool = False) -> RunResult:
        records: list[RoundRecord] = []
        cum = 0
        tel = self.telemetry
        run_t0 = time.time()
        try:
            with torch.no_grad(), tel.activate():
                while len(records) < rounds:
                    t0 = time.time()
                    with obs_trace.span("round", n=len(records) + 1):
                        intake = self.scheduler.next_round()
                        survivors = [intake.contributions[i]
                                     for i in intake.survivors]
                        up_bytes = sum(c.payload_bytes
                                       for c in intake.contributions)
                        down_bytes = 0
                        if survivors:
                            # streaming ingest hands over the aggregate it
                            # folded; gather aggregates the decoded trees
                            agg = (intake.preagg
                                   if intake.preagg is not None
                                   else self.aggregate(survivors,
                                                       intake.weights))
                            self.server, down_bytes = self.server_step(
                                self.server, agg, self.downlink,
                                intake.receivers, self.uplink.transmit)
                            self.version += 1
                        cum += up_bytes + down_bytes
                        acc = self.evaluate(self.server)
                    rec = RoundRecord(
                        round=len(records) + 1, test_acc=acc,
                        up_bytes=up_bytes, down_bytes=down_bytes,
                        cum_bytes=cum,
                        mean_val_acc=self._mean_metric(intake, "val_acc"),
                        update_sparsity=self._mean_metric(intake,
                                                          "update_sparsity"),
                        train_loss=self._mean_metric(intake, "train_loss"),
                        wall_s=time.time() - t0,
                        participants=tuple(c.client for c in survivors),
                        sim_time_s=intake.sim_time)
                    if tel.on:
                        self._record_round_metrics(rec, intake, run_t0)
                        rec.telemetry = tel.round_snapshot(rec.round)
                    records.append(rec)
                    if verbose:
                        print(f"[{self.config_name}] "
                              + self.scheduler.log_line(rec, intake))
        finally:
            self.uplink.close()
            tel.close()
        return RunResult(self.config_name, records, server=self.server,
                         telemetry=tel)


def run_simulation(model, cfg: ProtocolConfig, splits: FederatedSplits,
                   rounds: int, *, seed: int = 42,
                   engine: EngineConfig | None = None, init_state=None,
                   plan=None, device=None, verbose: bool = False) -> RunResult:
    """Run ``rounds`` aggregations of the federated simulation on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    return FederatedEngine(model, cfg, splits, seed=seed, engine_cfg=engine,
                           init_state=init_state, plan=plan,
                           device=device).run(rounds, verbose=verbose)
