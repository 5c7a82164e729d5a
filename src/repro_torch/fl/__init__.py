"""Federated engine of the port: stages, schedulers, scenarios.

Port of ``repro.fl``: it exports every name the reference's package does,
plus ``build_engine``, ``build_protocol`` and ``default_setting`` of
``fl.scenarios``.
"""
from repro_torch.comms.channel import ChannelConfig
from repro_torch.fl.async_buffer import (AsyncConfig, BufferEntry,
                                         TreeAccumulator, aggregate_buffer,
                                         client_latencies,
                                         normalized_staleness_weights,
                                         staleness_weight,
                                         weighted_mean_trees)
from repro_torch.fl.engine import (EngineConfig, FederatedEngine, RoundRecord,
                                   RunResult, encode_client_bytes,
                                   measure_update_bytes, run_simulation)
from repro_torch.fl.executors import (EXECUTORS, ClientExecutor,
                                      DistExecutor, SerialExecutor,
                                      ShardedExecutor, VmapExecutor,
                                      make_executor)
from repro_torch.fl.ingest import (IngestConfig, IngestResult, IngestStats,
                                   RejectedPayload, StreamingIngest)
from repro_torch.fl.population import (TRAFFIC_PRESETS, ClientStateStore,
                                       InMemoryStore, ShardedLazyStore,
                                       SplitsView, StoreConfig, TrafficConfig,
                                       TrafficModel, VirtualPopulationView,
                                       make_store, make_view)
from repro_torch.fl.rounds import (SCHEDULERS, Aggregate, AggregatedRound,
                                   BufferedAsyncScheduler, CohortPlan,
                                   Contribution, Downlink, Evaluate,
                                   LocalTrain, RoundIntake, RoundScheduler,
                                   ServerStep, SyncScheduler, Uplink)
from repro_torch.fl.sampling import (EmptyCohortError, SamplingConfig,
                                     gather_clients, pad_clients,
                                     sample_cohort, scatter_clients,
                                     stream_cohort)
from repro_torch.fl.scenarios import (SCENARIOS, Scenario, build_engine,
                                      build_protocol, default_setting,
                                      get_scenario, list_scenarios, register,
                                      run_scenario, validate_scenario)
from repro_torch.fl.server_opt import (ServerOptConfig, make_server_opt,
                                       server_step, server_update)
from repro_torch.obs import Telemetry, make_telemetry

__all__ = [
    "Telemetry", "make_telemetry",
    "ChannelConfig",
    "AsyncConfig", "BufferEntry", "TreeAccumulator",
    "aggregate_buffer", "client_latencies",
    "normalized_staleness_weights", "staleness_weight", "weighted_mean_trees",
    "EngineConfig", "FederatedEngine", "RoundRecord", "RunResult",
    "encode_client_bytes", "measure_update_bytes", "run_simulation",
    "SCHEDULERS", "Aggregate", "AggregatedRound", "BufferedAsyncScheduler",
    "CohortPlan", "Contribution", "Downlink", "Evaluate", "LocalTrain",
    "RoundIntake", "RoundScheduler", "ServerStep", "SyncScheduler", "Uplink",
    "EXECUTORS", "ClientExecutor", "DistExecutor", "SerialExecutor",
    "ShardedExecutor", "VmapExecutor", "make_executor",
    "IngestConfig", "IngestResult", "IngestStats", "RejectedPayload",
    "StreamingIngest",
    "ClientStateStore", "InMemoryStore", "ShardedLazyStore", "SplitsView",
    "StoreConfig", "TRAFFIC_PRESETS", "TrafficConfig", "TrafficModel",
    "VirtualPopulationView", "make_store", "make_view",
    "EmptyCohortError",
    "SamplingConfig", "gather_clients", "pad_clients", "sample_cohort",
    "scatter_clients", "stream_cohort",
    "SCENARIOS", "Scenario", "build_engine", "build_protocol",
    "default_setting", "get_scenario", "list_scenarios", "register",
    "run_scenario", "validate_scenario",
    "ServerOptConfig", "make_server_opt", "server_step", "server_update",
]
