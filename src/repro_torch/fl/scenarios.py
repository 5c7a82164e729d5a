"""Scenario registry: named, reproducible federated settings.

Port of ``repro.fl.scenarios``: 34 of the reference's 35 scenarios, all
but ``sync_full_fedavg_raw`` on the FSFL protocol (Table-2 row ``fsfl``,
whose cohort runs the ``level_assign`` kernel once a round, over all its
clients' leaves).  The other one, ``dist_cohort_full``, raises
``runtime.not_ported`` naming the port queue item it waits on
(``NOT_PORTED``).  A scenario that names no
executor trains its cohort, or an async window, in one batched call
(``executor="vmap"``).

* ``sync_full_fedavg_fsfl``: the paper's setting, all 8 clients, FedAvg,
  nnc-cabac payloads encoded per client on the host;
* ``device_encode_cabac``: the same with the cohort's row-skip flags
  computed on the device and one device-to-host copy per cohort;
* ``bidi_sync_full``: the paper's setting with the server's broadcast
  compressed too (§5.2): its own error feedback, top-k, ``STEP_SIZE_BI``
  levels (one ``level_assign`` launch per broadcast) and nnc-cabac;
* ``codec_int8_k4`` / ``device_encode_int8``: cohorts of 4 of 8 with
  int8-blockscale payloads, one ``delta_compress`` launch per client or
  one ``delta_compress_batch`` launch per cohort;
* ``partial_fc_k4``: the paper's partial-update setting, cohorts of 4,
  only the classifier (``fc*``) trains and goes on the wire;
* ``bnwire_v2_full``: wire schema v2, the clients' BN statistics inside
  every payload;
* ``chan_slow_cabac`` / ``chan_slow_raw``: a 1 Mbit/s uplink, where the
  compression ratio becomes simulated round time (``sim_time_s``);
* ``chan_lossy_k4``: 10% upload drops and spread bandwidths, cohorts of
  4, each lost update re-injected into its client's residual (Eq. 5);
* ``sync_full_fedavg_raw`` (protocol ``fedavg``, full float32 on the
  wire) and ``exec_serial_k4`` (the serial executor, cohorts of 4);
* ``sharded_cohort_full``: the batched round over a 1-D mesh of every
  visible device, one block of the cohort a device;
* the FedOpt servers and weighted sampling over cohorts of 4:
  ``sync_k4_fedadam``, ``sync_k4_fedavgm``, ``sync_k4_fedadagrad``,
  ``sync_weighted_k4``;
* dirichlet label partitions: ``noniid_dir01_fsfl``,
  ``noniid_dir01_golomb``, ``noniid_dir01_fp16`` (alpha 0.1) and
  ``noniid_dir1_k4_fedyogi`` (alpha 1, cohorts of 4, FedYogi);
* buffered async (FedBuff): ``async_b4_fsfl`` (buffer 4, 4 concurrent),
  ``async_b2_m4_fedadam`` (buffer 2, FedAdam), ``bnwire_v2_async``
  (buffer 2, 3 concurrent, schema v2) and ``async_windowed_b4``
  (clients finishing within 0.5 s of each other train in one executor
  call, ``VmapExecutor.run_stacked``);
* the host uplink: ``uplink_pool_k8`` (fp16 round trips on a thread
  pool), ``cabac_fast_batch_k8`` and ``cabac_fast_pool_k8`` (nnc-cabac
  through the batch API in at most 2 tasks a cohort, on a thread or a
  forkserver pool), each payload byte-identical to the serial uplink's;
* streaming ingest: ``stream_ingest_k8`` (each payload decoded and folded
  into running accumulators), ``stream_ingest_spec_k8`` (the speculative
  CABAC decoder) and ``stream_ingest_async_b4`` (FedBuff decoding its
  buffer at the flush);
* the population axis: ``pop_100k_diurnal`` (10^5 virtual clients over
  the base shards, cohorts of 32 streamed through the sharded store,
  diurnal availability), ``pop_1m_lazy_k32`` (10^6 clients, only the
  touched shards materialize) and ``churn_midround_async`` (async over
  10^4 clients, 15% mid-round churn, adaptive dispatch windows at the
  default per-call saving of 0.05 s unless ``call_saving_s`` is given).

    from repro_torch.fl import run_scenario
    result = run_scenario("sync_full_fedavg_fsfl", rounds=2)   # on CUDA
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.comms.channel import ChannelConfig
from repro_torch.core.protocol import ProtocolConfig, baseline_configs
from repro_torch.data import federated, synthetic
from repro_torch.fl.async_buffer import AsyncConfig
from repro_torch.fl.engine import EngineConfig, RunResult, run_simulation
from repro_torch.fl.executors import DIST_ITEM
from repro_torch.fl.ingest import IngestConfig
from repro_torch.fl.population import (DIURNAL_DEFAULT, StoreConfig,
                                       TrafficConfig)
from repro_torch.fl.sampling import SamplingConfig
from repro_torch.fl.server_opt import ServerOptConfig
from repro_torch.models import cnn
from repro_torch.runtime import not_ported


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str = ""
    protocol: str = "fsfl"       # key into baseline_configs
    protocol_overrides: tuple[tuple[str, Any], ...] = ()
    partial_updates: bool = False
    num_clients: int = 8
    cohort_size: int | None = None
    sampling_strategy: str = "uniform"
    sampling_weights: tuple[float, ...] | None = None
    # the population axis (fl.population)
    population: int | None = None   # virtual clients over the base shards
    store: str = "memory"           # client-state backend ("memory"|"sharded")
    store_shard_size: int = 64
    store_hot_shards: int = 16
    traffic: TrafficConfig | None = None  # trace-driven arrivals and churn
    adaptive_window: bool = False   # async: arrival-adaptive dispatch batch
    server_opt: str = "fedavg"
    server_lr: float = 1.0
    server_momentum: float = 0.9
    mode: str = "sync"
    buffer_size: int = 4
    concurrency: int = 4
    staleness_exponent: float = 0.5
    dispatch_window: float = 0.0    # async: batch same-window finishers
    bidirectional: bool = False
    rounds: int = 3
    executor: str = "vmap"
    mesh_shape: tuple[int, ...] | None = None   # sharded: 1-D cohort mesh
    codec: str = "auto"
    wire_schema: int = 1
    device_encode: bool = False
    channel: ChannelConfig | None = None
    dirichlet_alpha: float | None = None
    uplink_workers: int = 0           # > 1: a pool of wire round trips
    uplink_executor: str = "thread"   # "thread" | "process"
    uplink_batch: bool = False        # batch API: <= workers tasks a cohort
    ingest: str = "gather"            # "gather" | "streaming"
    ingest_engine: str = "vectorized"  # streaming decode engine
    telemetry: str = "off"            # "off" | "metrics" | "trace"
    metrics_out: str | None = None    # per-round metrics JSONL stream


def _fc_only(path: str, leaf) -> bool:
    return path.startswith("fc")


def build_protocol(s: Scenario, rounds: int) -> ProtocolConfig:
    cfgs = baseline_configs(
        fixed_sparsity=0.9, batch_size=32, local_lr=2e-3,
        scale_lr=2e-2, scale_subepochs=2, scale_schedule="linear",
        total_rounds=rounds)
    over = dict(s.protocol_overrides)
    if s.partial_updates:
        over.setdefault("trainable_predicate", _fc_only)
    over.setdefault("name", s.name)
    return dataclasses.replace(cfgs[s.protocol], **over)


def build_engine(s: Scenario) -> EngineConfig:
    return EngineConfig(
        sampling=SamplingConfig(cohort_size=s.cohort_size,
                                strategy=s.sampling_strategy,
                                weights=s.sampling_weights),
        server_opt=ServerOptConfig(name=s.server_opt, lr=s.server_lr,
                                   momentum=s.server_momentum),
        mode=s.mode,
        async_cfg=AsyncConfig(buffer_size=s.buffer_size,
                              concurrency=s.concurrency,
                              staleness_exponent=s.staleness_exponent,
                              dispatch_window=s.dispatch_window,
                              adaptive_window=s.adaptive_window),
        population=s.population,
        store=StoreConfig(backend=s.store, shard_size=s.store_shard_size,
                          max_hot_shards=s.store_hot_shards),
        traffic=s.traffic,
        bidirectional=s.bidirectional,
        executor=s.executor,
        mesh_shape=s.mesh_shape,
        codec=s.codec,
        channel=s.channel,
        wire_schema=s.wire_schema,
        device_encode=s.device_encode,
        uplink_workers=s.uplink_workers,
        uplink_executor=s.uplink_executor,
        uplink_batch=s.uplink_batch,
        ingest=s.ingest,
        ingest_opts=IngestConfig(decode_engine=s.ingest_engine),
        telemetry=s.telemetry,
        metrics_out=s.metrics_out,
        # partial updates have no deltas outside the classifier, so the
        # wire leaves those leaves out entirely
        up_predicate=_fc_only if s.partial_updates else None)


def default_setting(num_clients: int, *, n_samples: int = 640, seed: int = 0,
                    dirichlet_alpha: float | None = None):
    """Tiny VGG + synthetic CIFAR-like split, drawn with torch generators
    (the reference's ``default_setting`` shapes, not its numbers)."""
    task = synthetic.ImageTask("cifar_like", 10, 3, prototypes_per_class=2,
                               noise=0.3)
    x, y = synthetic.make_image_dataset(torch.Generator().manual_seed(seed),
                                        task, n_samples)
    splits = federated.split_federated(
        torch.Generator().manual_seed(seed + 1), x, y, num_clients,
        dirichlet_alpha=dirichlet_alpha)
    model = cnn.make_vgg("vgg_scenario", [8, 16, 32], 10, 3,
                         dense_width=16, pool_after=(0, 1, 2))
    return model, splits


SCENARIOS: dict[str, Scenario] = {}


def validate_scenario(s: Scenario) -> None:
    """Reject conflicting axes when a Scenario is defined, with the
    engine's own error messages prefixed by the scenario's name."""
    if s.protocol not in baseline_configs():
        known = ", ".join(sorted(baseline_configs()))
        raise ValueError(f"scenario {s.name!r}: unknown protocol "
                         f"{s.protocol!r} (known: {known})")
    try:
        build_engine(s).validate(s.num_clients)
    except ValueError as e:
        raise ValueError(f"scenario {s.name!r}: {e}") from None


def register(s: Scenario) -> Scenario:
    if s.name in SCENARIOS:
        raise ValueError(f"scenario {s.name!r} already registered")
    validate_scenario(s)
    SCENARIOS[s.name] = s
    return s


# the reference's scenarios that are not ported yet, with the port-queue
# item each waits on
NOT_PORTED = {"dist_cohort_full": DIST_ITEM}


def get_scenario(name: str) -> Scenario:
    if name in NOT_PORTED:
        raise not_ported(f"scenario {name!r}", NOT_PORTED[name])
    try:
        return SCENARIOS[name]
    except KeyError:
        known = ", ".join(sorted(SCENARIOS))
        raise KeyError(f"unknown scenario {name!r}; known: {known}") from None


register(Scenario("sync_full_fedavg_fsfl",
                  "seed-parity setting: all clients, FedAvg server, FSFL "
                  "protocol"))
register(Scenario("device_encode_cabac",
                  "device cohort encode for DeepCABAC: pass-1 row-skip "
                  "flags computed on device for the stacked cohort, pass-2 "
                  "range coding on host; payloads byte-identical to the "
                  "host path",
                  device_encode=True))
register(Scenario("bidi_sync_full",
                  "bidirectional compression of the server broadcast (§5.2)",
                  bidirectional=True))
register(Scenario("codec_int8_k4",
                  "int8-blockscale wire payloads (fused int8 quantizer, "
                  "one launch per client)",
                  cohort_size=4, codec="int8-blockscale"))
register(Scenario("device_encode_int8",
                  "device cohort encode: the whole cohort's int8-blockscale "
                  "payloads come out of ONE fused (K, n) launch "
                  "(byte-identical to the per-client path)",
                  cohort_size=4, codec="int8-blockscale", device_encode=True))
register(Scenario("partial_fc_k4",
                  "classifier-only partial updates with cohort sampling "
                  "(layer-selective wire payloads)",
                  cohort_size=4, partial_updates=True))
register(Scenario("chan_slow_cabac",
                  "1 Mbps uplink, 50 ms latency: DeepCABAC payloads",
                  channel=ChannelConfig(up_mbps=1.0, down_mbps=8.0,
                                        latency_s=0.05)))
register(Scenario("chan_slow_raw",
                  "same constrained channel, uncompressed fp32 payloads — "
                  "compression ratio becomes round time",
                  codec="raw-fp32",
                  channel=ChannelConfig(up_mbps=1.0, down_mbps=8.0,
                                        latency_s=0.05)))
register(Scenario("chan_lossy_k4",
                  "10% upload drop rate, heterogeneous bandwidths, cohorts "
                  "of 4",
                  cohort_size=4,
                  channel=ChannelConfig(up_mbps=4.0, down_mbps=16.0,
                                        latency_s=0.02, bandwidth_sigma=0.5,
                                        drop_rate=0.1)))
register(Scenario("bnwire_v2_full",
                  "wire schema v2: BN statistics travel inside every codec "
                  "payload (nothing out-of-band)",
                  wire_schema=2))
register(Scenario("sync_full_fedavg_raw",
                  "uncompressed FedAvg baseline (full fp32 on the wire)",
                  protocol="fedavg"))
register(Scenario("exec_serial_k4",
                  "per-client execution of the sync cohort, cohorts of 4",
                  cohort_size=4, executor="serial"))
register(Scenario("sharded_cohort_full",
                  "cohort axis sharded across every visible device (the "
                  "batched round in one block a device; ragged cohorts pad "
                  "to the mesh size)",
                  executor="sharded"))
register(Scenario("sync_k4_fedadam",
                  "cohorts of 4 of 8, FedAdam server optimizer",
                  cohort_size=4, server_opt="fedadam", server_lr=1e-2))
register(Scenario("sync_k4_fedavgm",
                  "cohorts of 4 of 8, server momentum 0.9",
                  cohort_size=4, server_opt="fedavgm"))
register(Scenario("sync_weighted_k4",
                  "size-weighted cohort sampling (availability-skewed "
                  "clients)",
                  cohort_size=4, sampling_strategy="weighted",
                  sampling_weights=(1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 4.0,
                                    4.0)))
register(Scenario("sync_k4_fedadagrad",
                  "cohorts of 4 of 8, FedAdagrad server optimizer",
                  cohort_size=4, server_opt="fedadagrad", server_lr=1e-2))
register(Scenario("noniid_dir01_fsfl",
                  "pathological heterogeneity: dirichlet(0.1) label "
                  "partition",
                  dirichlet_alpha=0.1))
register(Scenario("noniid_dir1_k4_fedyogi",
                  "mild heterogeneity dirichlet(1.0), cohorts of 4, FedYogi",
                  dirichlet_alpha=1.0, cohort_size=4, server_opt="fedyogi",
                  server_lr=1e-2))
register(Scenario("noniid_dir01_golomb",
                  "dirichlet(0.1) with the exp-Golomb wire codec",
                  dirichlet_alpha=0.1, codec="golomb"))
register(Scenario("noniid_dir01_fp16",
                  "dirichlet(0.1) with lossy fp16 wire payloads",
                  dirichlet_alpha=0.1, codec="fp16"))
register(Scenario("async_b4_fsfl",
                  "FedBuff-style buffer of 4, 4 concurrent heterogeneous "
                  "clients",
                  mode="async", buffer_size=4, concurrency=4))
register(Scenario("async_b2_m4_fedadam",
                  "aggressive async: aggregate every 2 updates, FedAdam "
                  "server",
                  mode="async", buffer_size=2, concurrency=4,
                  server_opt="fedadam", server_lr=1e-2))
register(Scenario("bnwire_v2_async",
                  "schema v2 under buffered-async scheduling: "
                  "staleness-weighted BN arrives via decoded messages",
                  mode="async", buffer_size=2, concurrency=3, wire_schema=2))
register(Scenario("async_windowed_b4",
                  "buffered async with a 0.5 s dispatch window: "
                  "concurrently finishing clients train in ONE executor "
                  "call",
                  mode="async", buffer_size=4, concurrency=4,
                  dispatch_window=0.5))

register(Scenario("uplink_pool_k8",
                  "thread-pooled per-client wire round trips (fp16 payloads "
                  "release the GIL)",
                  codec="fp16", uplink_workers=2))
register(Scenario("cabac_fast_batch_k8",
                  "batched uplink intake: the cohort's DeepCABAC messages "
                  "code through the codec batch API in <= W thread-pool "
                  "tasks (byte-identical payloads)",
                  uplink_workers=2, uplink_batch=True))
register(Scenario("cabac_fast_pool_k8",
                  "batched uplink over the forkserver pool: workers return "
                  "flat arrays instead of pickled trees",
                  uplink_workers=2, uplink_executor="process",
                  uplink_batch=True))
register(Scenario("stream_ingest_k8",
                  "decode-and-accumulate ingest: every payload folds into "
                  "the running accumulators on arrival, O(1) server memory "
                  "in the cohort size",
                  ingest="streaming"))
register(Scenario("stream_ingest_spec_k8",
                  "streaming ingest decoding through the speculative "
                  "multi-symbol CABAC engine",
                  ingest="streaming", ingest_engine="speculative"))
register(Scenario("stream_ingest_async_b4",
                  "buffered-async decode at flush: the FedBuff buffer holds "
                  "payload bytes, staleness-weighted folding at aggregation",
                  mode="async", buffer_size=4, concurrency=4,
                  ingest="streaming"))

register(Scenario("pop_100k_diurnal",
                  "10^5 virtual clients over 8 data shards, K=32 cohorts "
                  "streamed through the sharded lazy store, diurnal "
                  "availability with timezone spread gating every cohort",
                  population=100_000, cohort_size=32, store="sharded",
                  store_shard_size=16, store_hot_shards=8,
                  traffic=TrafficConfig(diurnal=DIURNAL_DEFAULT,
                                        day_s=240.0, timezone_spread=0.25,
                                        latency_mean=2.0)))
register(Scenario("pop_1m_lazy_k32",
                  "a million-client population, K=32: peak memory stays "
                  "O(cohort), only touched shards ever materialize, the LRU "
                  "spills the rest to disk",
                  population=1_000_000, cohort_size=32, store="sharded",
                  store_shard_size=16, store_hot_shards=8))
register(Scenario("churn_midround_async",
                  "buffered async over 10^4 clients with 15% mid-round "
                  "churn and an arrival-adaptive dispatch window (batch "
                  "while the marginal wait beats the per-call saving)",
                  mode="async", buffer_size=4, concurrency=8,
                  population=10_000, store="sharded", store_shard_size=16,
                  store_hot_shards=8, adaptive_window=True,
                  traffic=TrafficConfig(churn_rate=0.15, latency_mean=2.0)))



def run_scenario(scenario: str | Scenario, *, rounds: int | None = None,
                 seed: int = 42, model=None, splits=None, init_state=None,
                 plan=None, device=None, verbose: bool = False) -> RunResult:
    """Run a (named or ad-hoc) scenario end to end on ``device`` (CUDA
    unless ``"cpu"`` is asked for).  ``init_state``/``plan`` fix the
    initial state and the per-round cohorts and batch indices (see
    ``FederatedEngine``)."""
    s = get_scenario(scenario) if isinstance(scenario, str) else scenario
    rounds = rounds if rounds is not None else s.rounds
    if (model is None) != (splits is None):
        raise ValueError("pass both model and splits, or neither")
    if model is None:
        model, splits = default_setting(s.num_clients,
                                        dirichlet_alpha=s.dirichlet_alpha)
    if splits.num_clients != s.num_clients:
        if (s.sampling_weights is not None
                and len(s.sampling_weights) != splits.num_clients):
            raise ValueError(
                f"scenario {s.name!r} defines {len(s.sampling_weights)} "
                f"sampling weights but splits have {splits.num_clients} "
                "clients")
        s = dataclasses.replace(s, num_clients=splits.num_clients)
    return run_simulation(model, build_protocol(s, rounds), splits, rounds,
                          seed=seed, engine=build_engine(s),
                          init_state=init_state, plan=plan, device=device,
                          verbose=verbose)
