"""The channel model and the sync scheduler's drop path against the
reference.

* ``core/prand.py``: every draw bit-equal to the reference's.
* ``ChannelModel``: up, down and round times and ``dropped`` equal over a
  grid of configurations (latency jitter and bandwidth spread included)
  and of (client, round, bytes).
* ``chan_lossy_k4`` on the tiny scenario VGG (the port's synthetic data
  given to both), from the reference's initial state along its cohorts
  and batch orders: the participants of every
  round equal the reference's, ``sim_time_s`` equals the reference
  channel's ``round_time`` summed over the port's own payload sizes, and a
  dropped client's residual is its carry plus its decoded delta, bit for
  bit.
* The re-injection teacher-forced: the same residual and decoded delta
  give the reference's residual bit for bit.
* A channel that drops every upload freezes the server while the clients'
  payloads grow (Eq. 5 across drops); a channel needs the wire; an empty
  cohort advances the clock by 1 s, as in the reference.
* ``chan_lossy_k4`` with bidirectional compression, against the
  reference along its cohorts: the download leg of each round's clock is
  the last compressed broadcast (``broadcast_ref_bytes`` switches from the
  raw model after round 1, in both packages, to sizes within 2%), the
  drops and participants are the reference's, and ``sim_time_s`` equals
  the reference channel's ``round_time`` over the port's own upload and
  broadcast sizes (teacher-forced), within 5% of the reference's clock.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comms import channel as ref_channel
from repro.core import prand as ref_prand
from repro.data.federated import FederatedSplits as RefSplits
from repro.data.federated import client_epoch_batches
from repro.fl import scenarios as ref_scenarios
from repro.fl.engine import FederatedEngine as RefEngine
from repro.fl.sampling import SamplingConfig as RefSampling
from repro.fl.sampling import sample_cohort
from repro.models import cnn as ref_cnn
from repro_torch import comms, convert
from repro_torch.comms import channel
from repro_torch.core import prand
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.fl import engine, scenarios
from repro_torch.fl.sampling import SamplingConfig
from repro_torch.tree import sorted_items


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())


KEYS = [(0,), (0, 0x5A, 3), (7, 0x5C, 11, 4), (2**40, 1, 2, 3, 4),
        (3, np.arange(50)), (np.arange(12).reshape(3, 4), 9, np.ones(
            (3, 4), np.int64))]


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
def test_prand_draws_equal_reference(key):
    for fn in ("fold", "uniform", "normal"):
        assert _bits_equal(getattr(prand, fn)(*key),
                           getattr(ref_prand, fn)(*key)), fn
    assert _bits_equal(prand.randint(97, *key), ref_prand.randint(97, *key))
    for tag in ("TAG_BW_UP", "TAG_BW_DOWN", "TAG_CHAN_LAT", "TAG_SAMPLE"):
        assert getattr(prand, tag) == getattr(ref_prand, tag)


CONFIGS = [
    dict(),
    dict(up_mbps=1.0, down_mbps=8.0, latency_s=0.05),
    dict(up_mbps=4.0, down_mbps=16.0, latency_s=0.02, bandwidth_sigma=0.5,
         drop_rate=0.1),
    dict(up_mbps=2.5, down_mbps=math.inf, latency_s=0.1, latency_sigma=0.3,
         bandwidth_sigma=0.8, drop_rate=0.4, seed=5),
    dict(up_mbps=10.0, latency_s=0.0, latency_sigma=0.3, drop_rate=1.0,
         seed=2),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=range(len(CONFIGS)))
def test_channel_times_and_drops_equal_reference(cfg):
    port = channel.ChannelModel(channel.ChannelConfig(**cfg), 8)
    ref = ref_channel.ChannelModel(ref_channel.ChannelConfig(**cfg), 8)
    for client in range(10):
        for rnd in range(5):
            assert port.dropped(rnd, client) == ref.dropped(rnd, client)
            for nbytes in (0, 727, 29_473, 3_399_336):
                assert port.up_time(client, nbytes, rnd) == ref.up_time(
                    client, nbytes, rnd)
                assert port.down_time(client, nbytes, rnd) == \
                    ref.down_time(client, nbytes, rnd)
    clients, sizes = [3, 0, 6, 1], [1_000, 50_000, 7, 29_473]
    for rnd in range(4):
        assert port.round_time(clients, sizes, 3_399_336, rnd) == \
            ref.round_time(clients, sizes, 3_399_336, rnd)
    assert port.round_time([], [], 10, 1) == 0.0


# ------------------------------------------------------------ chan_lossy_k4

ROUNDS = 2          # round 2 drops clients 0 and 2 of its cohort


def _setting(name, rounds, **changes):
    """The port's tiny setting (its arrays also the reference's), the
    reference engine, its cohorts and batch orders for ``rounds`` rounds
    (its key discipline replayed), and the port's engine from the
    reference's initial state along that plan; ``changes`` replace fields
    of both scenarios."""
    s = dataclasses.replace(ref_scenarios.get_scenario(name), **changes)
    cfg = ref_scenarios.build_protocol(s, rounds)
    model, splits = scenarios.default_setting(s.num_clients)
    ref_splits = RefSplits(*(
        jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
        for a in (getattr(splits, f).numpy() for f in (
            "client_x", "client_y", "client_val_x", "client_val_y",
            "test_x", "test_y"))))
    n_train = ref_splits.client_x.shape[1]
    key = jax.random.PRNGKey(42)
    _, key = jax.random.split(key)      # k_init: the engine's init
    plan = []
    for _ in range(rounds):
        key, kb = jax.random.split(key)
        key, ks = jax.random.split(key)
        idx = sample_cohort(ks, s.num_clients,
                            RefSampling(cohort_size=s.cohort_size))
        plan.append((idx, np.asarray(client_epoch_batches(
            kb, len(idx), n_train, cfg.batch_size))))
    ref = RefEngine(ref_cnn.make_vgg("vgg_scenario", [8, 16, 32], 10, 3,
                                     dense_width=16, pool_after=(0, 1, 2)),
                    cfg, ref_splits, jax.random.PRNGKey(42),
                    ref_scenarios.build_engine(s))
    state = jax.device_get((ref.server, jax.tree.map(
        lambda x: x[0], ref.local_train.persistent)))
    port_s = dataclasses.replace(scenarios.get_scenario(name), **changes)
    port = engine.FederatedEngine(
        model, scenarios.build_protocol(port_s, rounds), splits,
        engine_cfg=scenarios.build_engine(port_s),
        init_state=convert.initial_state(*state), plan=plan, device="cpu")
    return s, ref, port, plan


def test_chan_lossy_k4_matches_reference():
    s, ref, port, plan = _setting("chan_lossy_k4", ROUNDS)
    ref_recs = ref.run(ROUNDS).records
    assert port.broadcast_ref_bytes() == ref.broadcast_ref_bytes() == 4 * sum(
        v.numel() for _, v in sorted_items(port.server.params))
    seen = {}
    train, intake = port.local_train.train_cohort, port.uplink.intake

    def spy_train(idx, *a):
        out = train(idx, *a)
        seen["carry"] = {c: {p: v[i].clone() for p, v in
                             sorted_items(out.persistent.residual)}
                         for i, c in enumerate(int(j) for j in idx)}
        return out

    def spy_intake(out, clients):
        seen["contribs"] = contribs = intake(out, clients)
        return contribs

    port.local_train.train_cohort = spy_train
    port.uplink.intake = spy_intake
    chan = ref_channel.ChannelModel(
        ref_channel.ChannelConfig(**dataclasses.asdict(s.channel)))
    assert s.channel == ref.engine_cfg.channel
    clock, drops = 0.0, 0
    for rnd, ((idx, _), r) in enumerate(zip(plan, ref_recs), 1):
        p = port.run(1).records[0]
        clients = [int(c) for c in idx]
        lost = [c for c in clients if chan.dropped(rnd, c)]
        assert p.participants == r.participants == tuple(
            c for c in clients if c not in lost)
        sizes = [c.payload_bytes for c in seen["contribs"]]
        assert sum(sizes) == p.up_bytes
        clock += chan.round_time(clients, sizes, ref.broadcast_ref_bytes(),
                                 rnd)
        assert p.sim_time_s == clock
        assert math.isclose(p.sim_time_s, r.sim_time_s, rel_tol=0.05)
        # Eq. 5: a lost client's residual is its carry + its decoded delta
        residual = dict(sorted_items(port.local_train.state.residual))
        for c in seen["contribs"]:
            if c.client not in lost:
                continue
            drops += 1
            decoded = dict(sorted_items(c.delta_params))
            for path, carry in seen["carry"][c.client].items():
                want = carry + torch.tensor(decoded[path])
                assert torch.equal(residual[path][c.client].view(torch.int32),
                                   want.view(torch.int32)), (rnd, path)
    assert drops >= 1 and len(ref_recs) == ROUNDS


def test_reinjection_teacher_forced_equals_reference():
    _, ref, port, _ = _setting("chan_lossy_k4", 1)
    rng = np.random.default_rng(0)
    pers = jax.device_get(ref.local_train.persistent)
    residual = jax.tree.map(
        lambda r: (1e-4 * rng.standard_normal(r.shape)).astype(np.float32),
        pers.residual)
    ref.local_train.persistent = pers._replace(
        residual=jax.tree.map(jax.numpy.asarray, residual))
    port.local_train.state = port.local_train.state._replace(
        residual=convert.to_tensors(residual))
    delta = jax.tree.map(
        lambda r: (3e-4 * rng.standard_normal(r.shape[1:])
                   * (rng.random(r.shape[1:]) < 0.2)).astype(np.float32),
        residual)
    for client in (3, 0):
        ref.local_train.reinject_residual(client, delta)
        port.local_train.reinject_residual(client, delta)
    want = dict(sorted_items(jax.device_get(
        ref.local_train.persistent.residual)))
    for path, v in sorted_items(port.local_train.state.residual):
        assert _bits_equal(v.numpy(), want[path]), path


def _tiny2():
    model, splits = scenarios.default_setting(2, n_samples=480)
    cfg = ProtocolConfig(name="fsfl", method="sparse", fixed_sparsity=0.9,
                         error_feedback=True, batch_size=32, local_lr=2e-3)
    return model, splits, cfg


def test_total_drop_stalls_server_but_residual_retransmits():
    """drop_rate=1.0 with error feedback: nothing aggregates (server
    frozen, no participants), yet the clients carry the lost mass, so the
    second round's payloads are larger than the first's."""
    model, splits, cfg = _tiny2()
    eng = engine.FederatedEngine(
        model, cfg, splits, seed=7,
        engine_cfg=engine.EngineConfig(
            channel=comms.ChannelConfig(drop_rate=1.0)), device="cpu")
    params0 = {p: v.clone() for p, v in sorted_items(eng.server.params)}
    res = eng.run(2)
    assert all(r.participants == () for r in res.records)
    assert res.records[0].test_acc == res.records[1].test_acc
    assert all(r.up_bytes > 0 for r in res.records)
    assert res.records[1].up_bytes > res.records[0].up_bytes
    for p, v in sorted_items(res.server.params):
        assert torch.equal(v, params0[p]), p


def test_channel_requires_wire():
    model, splits, cfg = _tiny2()
    with pytest.raises(ValueError, match="measure_bytes"):
        engine.run_simulation(
            model, cfg, splits, 1, engine=engine.EngineConfig(
                channel=comms.ChannelConfig(up_mbps=1.0),
                measure_bytes=False), device="cpu")
    with pytest.raises(ValueError, match="wire schema"):
        engine.EngineConfig(wire_schema=3).validate()


def test_empty_cohort_advances_the_clock_as_in_the_reference():
    rounds = 2
    s = ref_scenarios.get_scenario("chan_lossy_k4")
    cfg = ref_scenarios.build_protocol(s, rounds)
    model, splits = ref_scenarios.default_setting(8, n_samples=160)
    ref = RefEngine(model, cfg, splits, jax.random.PRNGKey(42),
                    dataclasses.replace(ref_scenarios.build_engine(s),
                                        sampling=RefSampling(cohort_size=0)))
    ref_recs = ref.run(rounds).records
    port_s = scenarios.get_scenario("chan_lossy_k4")
    port_model, port_splits = scenarios.default_setting(8)
    port = engine.FederatedEngine(
        port_model, scenarios.build_protocol(port_s, rounds), port_splits,
        engine_cfg=dataclasses.replace(scenarios.build_engine(port_s),
                                       sampling=SamplingConfig(cohort_size=0)),
        device="cpu")
    recs = port.run(rounds).records
    assert [r.sim_time_s for r in recs] == [r.sim_time_s for r in ref_recs] \
        == [1.0, 2.0]
    assert all(r.participants == () for r in recs)


def test_bidirectional_channel_clock_and_drops_match_reference():
    s, ref, port, plan = _setting("chan_lossy_k4", ROUNDS,
                                  bidirectional=True)
    raw = 4 * sum(v.numel() for _, v in sorted_items(port.server.params))
    chan = ref_channel.ChannelModel(
        ref_channel.ChannelConfig(**dataclasses.asdict(s.channel)))
    seen = {}
    intake = port.uplink.intake

    def spy(out, clients):
        contribs = intake(out, clients)
        seen["sizes"] = [c.payload_bytes for c in contribs]
        return contribs

    port.uplink.intake = spy
    clock, drops = 0.0, 0
    for rnd, (idx, _) in enumerate(plan, 1):
        down_ref = port.broadcast_ref_bytes()
        ref_down_ref = ref.broadcast_ref_bytes()
        assert (down_ref == ref_down_ref == raw) if rnd == 1 else (
            down_ref == port.downlink.last_payload_bytes < raw
            and abs(down_ref - ref_down_ref) <= 0.02 * ref_down_ref)
        r = ref.run(1).records[0]
        p = port.run(1).records[0]
        clients = [int(c) for c in idx]
        lost = [c for c in clients if chan.dropped(rnd, c)]
        drops += len(lost)
        assert p.participants == r.participants == tuple(
            c for c in clients if c not in lost)
        assert p.down_bytes > 0 and abs(p.down_bytes - r.down_bytes) <= (
            0.02 * r.down_bytes)
        clock += chan.round_time(clients, seen["sizes"], down_ref, rnd)
        assert p.sim_time_s == clock
        assert math.isclose(p.sim_time_s, r.sim_time_s, rel_tol=0.05)
    assert drops >= 1
