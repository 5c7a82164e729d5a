"""Scenario registry: named, reproducible federated settings.

Port of ``repro.fl.scenarios`` for the scenarios whose path reaches a
kernel, all on the FSFL protocol (Table-2 row ``fsfl``, whose client runs
the ``level_assign`` kernel once per client, over all its leaves):

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
  4, each lost update re-injected into its client's residual (Eq. 5).

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
from repro_torch.fl.engine import EngineConfig, RunResult, run_simulation
from repro_torch.fl.sampling import SamplingConfig
from repro_torch.fl.server_opt import ServerOptConfig
from repro_torch.models import cnn


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str = ""
    protocol: str = "fsfl"       # key into baseline_configs
    protocol_overrides: tuple[tuple[str, Any], ...] = ()
    partial_updates: bool = False
    num_clients: int = 8
    cohort_size: int | None = None
    server_opt: str = "fedavg"
    server_lr: float = 1.0
    mode: str = "sync"
    bidirectional: bool = False
    rounds: int = 3
    executor: str = "serial"
    codec: str = "auto"
    wire_schema: int = 1
    device_encode: bool = False
    channel: ChannelConfig | None = None
    dirichlet_alpha: float | None = None


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
        sampling=SamplingConfig(cohort_size=s.cohort_size),
        server_opt=ServerOptConfig(name=s.server_opt, lr=s.server_lr),
        mode=s.mode,
        bidirectional=s.bidirectional,
        executor=s.executor,
        codec=s.codec,
        channel=s.channel,
        wire_schema=s.wire_schema,
        device_encode=s.device_encode,
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
        build_engine(s).validate()
    except ValueError as e:
        raise ValueError(f"scenario {s.name!r}: {e}") from None


def register(s: Scenario) -> Scenario:
    if s.name in SCENARIOS:
        raise ValueError(f"scenario {s.name!r} already registered")
    validate_scenario(s)
    SCENARIOS[s.name] = s
    return s


def get_scenario(name: str) -> Scenario:
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
        s = dataclasses.replace(s, num_clients=splits.num_clients)
    return run_simulation(model, build_protocol(s, rounds), splits, rounds,
                          seed=seed, engine=build_engine(s),
                          init_state=init_state, plan=plan, device=device,
                          verbose=verbose)
