"""Buffered async scheduling (FedBuff) against the reference.

* ``normalized_staleness_weights``, ``TreeAccumulator``,
  ``weighted_mean_trees`` and ``aggregate_buffer`` bitwise equal to the
  reference's on both of its branches: host numpy trees (float64 fold,
  one division, one cast) and device trees (float32 ``sum(w_i * l_i)``).
* Teacher-forced runs of ``async_b4_fsfl``, ``async_windowed_b4``,
  ``bnwire_v2_async`` and ``async_b2_m4_fedadam``, 3 aggregations on the
  port's tiny setting (its arrays also the reference's; 1,280 samples, 3
  local steps a client) from the reference's initial state.  The
  reference's draws are captured by wrapping its functions (the latency
  vector, each ``select_available`` draw, each trained member's batch
  order) and given to the port as an ``AsyncPlan``; each port aggregation
  starts from the reference's state after the one before (server,
  server-optimizer state, clients' persistent states, in-flight
  snapshots by version).  The schedule is exactly the reference's: the
  buffer's clients in order, their staleness and arrival times, the
  weights (bitwise), the participants, the window sizes and
  ``sim_time_s``.  ``up_bytes`` within 2%.  The reference's decoded
  contributions through the port's ``Aggregate`` give the reference's
  aggregate bit for bit (schema v1's BN rows by the float32 sum,
  everything else by the float64 fold), and the port's ``ServerStep`` on
  it the reference's server within 1e-6.  Clients: Adam turns
  noise-level gradient signs into whole steps (ROADMAP.md section 3), so
  a client whose decoded update lies more than 5 params a quantization
  step or more off (top-k flips) or whose scales lie a fine step or more
  off (another kept sub-epoch) is counted apart, at most 1 an
  aggregation; every other client's update within 34 params off by more
  than 1e-6.  An aggregation without a counted client holds the server
  state to the whole-run bounds (params within a quantization step times
  the server optimizer's gain but 5, at most 34 off by more than 1e-6;
  scales within a fine step; test accuracy within one image).
* With a channel and bidirectional compression, each dispatch downloads
  the current broadcast (``broadcast_ref_bytes``): the raw model until
  the first aggregation, then the last compressed broadcast, in the
  reference's order and within 2% of its sizes.
* The validation of async settings is the reference's, the adaptive
  window's included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import async_buffer as ref_async
from repro.fl import rounds as ref_rounds
from repro.fl import scenarios as ref_scenarios
from repro.fl.engine import FederatedEngine as RefEngine
from repro.data.federated import FederatedSplits as RefSplits
from repro.models import cnn as ref_cnn
from repro_torch import comms, convert
from repro_torch.fl import async_buffer, engine, rounds, scenarios
from repro_torch.fl.executors import VmapExecutor
from repro_torch.tree import sorted_items
from test_torch_sampling import N_SAMPLES


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())


STALENESS = [[0, 0, 0, 0], [0, 1, 1, 3], [2, 0, 5], [7], [1, 1, 2, 9, 0, 4]]


@pytest.mark.parametrize("exponent", [0.0, 0.5, 1.0, 1.7])
def test_staleness_weights_bitwise(exponent):
    for st in STALENESS:
        got = async_buffer.normalized_staleness_weights(st, exponent)
        want = ref_async.normalized_staleness_weights(st, exponent)
        assert _bits(got, want)
        assert _bits(async_buffer.staleness_weight(st, exponent),
                     ref_async.staleness_weight(st, exponent))


def _trees(seed: int, n: int):
    rng = np.random.default_rng(seed)
    shapes = {"conv0": {"w": (8, 3, 3, 3)}, "bn0": {"mean": (8,),
                                                    "var": (8,)}}
    return [{m: {k: (rng.standard_normal(s)
                     * rng.choice([1e-3, 1.0, 30.0])).astype(np.float32)
                 for k, s in d.items()} for m, d in shapes.items()}
            for _ in range(n)]


def _equal_trees(port_tree, ref_tree) -> None:
    want = dict(sorted_items(jax.device_get(ref_tree)))
    got = dict(sorted_items(port_tree))
    assert got.keys() == want.keys()
    for path, v in got.items():
        v = v.numpy() if isinstance(v, torch.Tensor) else v
        assert _bits(v, want[path]), path


@pytest.mark.parametrize("n", [1, 2, 4, 7])
def test_tree_accumulator_and_weighted_mean_bitwise(n):
    trees = _trees(n, n)
    w = ref_async.normalized_staleness_weights(list(range(n)), 0.5)
    w_raw = np.random.default_rng(n).random(n) * 3.0
    for weights in (w, w_raw):
        ref_acc, acc = ref_async.TreeAccumulator(), async_buffer.TreeAccumulator()
        for wi, t in zip(weights, trees):
            ref_acc.add(t, wi)
            acc.add(t, wi)
        assert acc.weight_sum == ref_acc.weight_sum and acc.count == n
        _equal_trees(acc.mean(), ref_acc.mean())
        # the host branch: numpy trees fold in float64
        _equal_trees(async_buffer.weighted_mean_trees(trees, weights,
                                                      host=True),
                     ref_async.weighted_mean_trees(trees, weights))
        # the device branch: the reference's jax arrays, the port's tensors
        _equal_trees(
            async_buffer.weighted_mean_trees(
                [convert.to_tensors(t) for t in trees], weights, host=False),
            ref_async.weighted_mean_trees(
                [jax.tree.map(jnp.asarray, t) for t in trees], weights))
    with pytest.raises(ValueError, match="trees but"):
        async_buffer.weighted_mean_trees(trees, w[:-1], host=True)
    with pytest.raises(ValueError, match="empty"):
        async_buffer.TreeAccumulator().mean()


def test_aggregate_buffer_bitwise():
    trees = _trees(9, 4)
    staleness = [0, 2, 1, 5]
    ref_entries = [ref_async.BufferEntry(c, s, 0.5 * c, t, t, t, 10)
                   for c, (s, t) in enumerate(zip(staleness, trees))]
    entries = [async_buffer.BufferEntry(c, s, 0.5 * c, t, t,
                                        convert.to_tensors(t), 10)
               for c, (s, t) in enumerate(zip(staleness, trees))]
    got = async_buffer.aggregate_buffer(entries, 0.5, host_bn=False)
    want = ref_async.aggregate_buffer(
        [e._replace(bn_state=jax.tree.map(jnp.asarray, e.bn_state))
         for e in ref_entries], 0.5)
    for g, r in zip(got[:3], want[:3]):
        _equal_trees(g, r)
    assert _bits(got[3], want[3])


# ------------------------------------------------------------ whole runs

ROUNDS = 3
ASYNC = ["async_b4_fsfl", "async_windowed_b4", "bnwire_v2_async",
         "async_b2_m4_fedadam"]


def _port_setting():
    model, splits = scenarios.default_setting(8, n_samples=N_SAMPLES)
    ref_splits = RefSplits(*(
        jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
        for a in (getattr(splits, f).numpy() for f in (
            "client_x", "client_y", "client_val_x", "client_val_y",
            "test_x", "test_y"))))
    return model, splits, ref_splits


def _spy_aggregate(eng, log):
    agg = eng.aggregate

    def spy(contribs, weights=None):
        out = agg(contribs, weights)
        log.append((list(contribs), weights, out))
        return out

    eng.aggregate = spy


def async_runs(ref_s, port_s, n_rounds: int = ROUNDS, resync=True):
    """The reference's engine with its draws captured, then the port's
    along an ``AsyncPlan`` of them; both engines' aggregations logged.

    With ``resync`` every port aggregation is teacher-forced: it starts
    from the reference's state after the aggregation before (server,
    server-optimizer state, every client's persistent state, and the
    snapshot each in-flight client was dispatched with, by version), so a
    discrete divergence in one client's training stays in its own
    aggregation."""
    cfg = ref_scenarios.build_protocol(ref_s, n_rounds)
    model, splits, ref_splits = _port_setting()
    draws, batches, lat = [], [], []
    latencies0 = ref_rounds.client_latencies
    select0 = ref_rounds.CohortPlan.select_available
    batches0 = ref_rounds.epoch_batches

    def client_latencies(*a):
        lat.append(latencies0(*a))
        return lat[-1]

    def select_available(self, key, available, k):
        idx, key = select0(self, key, available, k)
        draws.append(np.asarray(idx))
        return idx, key

    def epoch_batches(*a):
        out = batches0(*a)
        batches.append(np.asarray(out))
        return out

    ref_log, port_log = [], []
    ref_recs, ref_states = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_rounds, "client_latencies", client_latencies)
        mp.setattr(ref_rounds.CohortPlan, "select_available",
                   select_available)
        mp.setattr(ref_rounds, "epoch_batches", epoch_batches)
        ref = RefEngine(ref_cnn.make_vgg("vgg_scenario", [8, 16, 32], 10, 3,
                                         dense_width=16,
                                         pool_after=(0, 1, 2)),
                        cfg, ref_splits, jax.random.PRNGKey(42),
                        ref_scenarios.build_engine(ref_s))
        server0 = jax.device_get(ref.server)
        pers0 = jax.device_get(jax.tree.map(lambda x: x[0],
                                            ref.local_train.persistent))
        _spy_aggregate(ref, ref_log)
        for _ in range(n_rounds):
            ref_recs += ref.run(1).records
            ref_states.append(jax.device_get(
                (ref.server, ref.server_step.state,
                 ref.local_train.persistent)))
    plan = rounds.AsyncPlan(latencies=lat[0], draws=draws, batches=batches)
    port = engine.FederatedEngine(
        model, scenarios.build_protocol(port_s, n_rounds), splits,
        engine_cfg=scenarios.build_engine(port_s),
        init_state=convert.initial_state(server0, pers0), plan=plan,
        device="cpu")
    _spy_aggregate(port, port_log)
    versions = {0: port.server}
    port_recs, port_servers, before = [], [], []
    for rnd in range(n_rounds):
        if resync and rnd:
            server, opt_state, pers = ref_states[rnd - 1]
            versions[rnd] = port.server = convert.server_state(server)
            port.server_step.state = convert.optimizer_state(opt_state)
            port.local_train.state = convert.client_persistent(pers)
            for e in port.scheduler.in_flight:
                e.server = versions[e.start_version]
        before.append((port.server, port.server_step.state))
        port_recs += port.run(1).records
        port_servers.append(convert.to_numpy(port.server))
    return (cfg, ref, port, ref_recs, [s[0] for s in ref_states],
            port_recs, port_servers, ref_log, port_log,
            len(ref_splits.test_y), before)


def _port_contribution(c, v2: bool):
    """The reference's decoded contribution as the port's uplink hands it
    over: decoded numpy trees; schema v1's BN as device tensors."""
    bn = c.bn_state if v2 else convert.to_tensors(jax.device_get(c.bn_state))
    return rounds.Contribution(client=c.client, delta_params=c.delta_params,
                               delta_scales=c.delta_scales, bn_state=bn,
                               payload_bytes=c.payload_bytes,
                               staleness=c.staleness,
                               arrival_time=c.arrival_time)


MAX_FLIPS = 5
MAX_OFF = 34         # 0.5% of the 6,786 params
MAX_COUNTED = 1      # clients an aggregation counted apart


def _diffs(port_tree, ref_tree):
    want = dict(sorted_items(ref_tree))
    return np.concatenate([np.abs(np.asarray(v) - np.asarray(want[p])).ravel()
                           for p, v in sorted_items(port_tree)])


def _counted_clients(cfg, r_c, p_c) -> list[int]:
    """Buffer positions whose training took another discrete decision: more
    than ``MAX_FLIPS`` decoded params a quantization step or more apart
    (top-k flips), or a scale delta more than one fine step apart (another
    kept sub-epoch).  The other clients are held to those bounds."""
    counted = []
    for i, (r, p) in enumerate(zip(r_c, p_c)):
        dp = _diffs(p.delta_params, r.delta_params)
        ds = _diffs(p.delta_scales, r.delta_scales)
        if (int(np.sum(dp > cfg.step_size * 1.01)) > MAX_FLIPS
                or ds.max() > cfg.fine_step_size * 1.01):
            counted.append(i)
        else:
            assert int(np.sum(dp > 1e-6)) <= MAX_OFF, (i, p.client)
    return counted


@pytest.mark.parametrize("name", ASYNC)
def test_async_run_schedule_equals_reference(name, monkeypatch):
    ref_s = ref_scenarios.get_scenario(name)
    stacked = []
    run_stacked = VmapExecutor.run_stacked   # the scenarios' executor

    def spy(self, servers, *a):
        stacked.append(len(servers))
        return run_stacked(self, servers, *a)

    monkeypatch.setattr(VmapExecutor, "run_stacked", spy)
    (cfg, ref, port, ref_recs, ref_servers, port_recs, port_servers,
     ref_log, port_log, n_test, before) = async_runs(
        ref_s, scenarios.get_scenario(name))
    assert len(ref_log) == len(port_log) == ROUNDS
    assert port.scheduler.batch_sizes == ref.scheduler.batch_sizes
    assert port.scheduler.now == ref.scheduler.now
    assert port.version == ref.version == ROUNDS
    gain = 1e-2 / 1e-3 if ref_s.server_opt == "fedadam" else 1.0
    v2 = ref_s.wire_schema == 2
    staleness, counted_all = [], []
    for rnd, ((r_c, r_w, r_agg), (p_c, p_w, p_agg), r, p, ref_srv,
              port_srv, (srv0, opt0)) in enumerate(zip(
                  ref_log, port_log, ref_recs, port_recs, ref_servers,
                  port_servers, before), 1):
        # the schedule, exactly
        assert [c.client for c in p_c] == [c.client for c in r_c]
        assert [c.staleness for c in p_c] == [c.staleness for c in r_c]
        assert [c.arrival_time for c in p_c] == [c.arrival_time
                                                 for c in r_c]
        assert _bits(p_w, r_w)
        assert p.participants == r.participants == tuple(c.client
                                                         for c in r_c)
        assert p.sim_time_s == r.sim_time_s
        assert len(r_c) >= ref_s.buffer_size
        staleness += [c.staleness for c in r_c]
        assert abs(p.up_bytes - r.up_bytes) <= 0.02 * r.up_bytes
        # the fold of each kind of leaf, teacher-forced: bitwise
        forced = rounds.Aggregate(torch.device("cpu"), True, v2)(
            [_port_contribution(c, v2) for c in r_c], r_w)
        for part in ("delta_params", "delta_scales", "bn_state"):
            _equal_trees(getattr(forced, part), getattr(r_agg, part))
        # the server step from the same state on the reference's aggregate
        step = rounds.ServerStep(port.server_step.opt)
        step.state = opt0
        new, _ = step(srv0, forced, port.downlink, 0, True)
        assert _diffs(convert.to_numpy(new.params),
                      ref_srv.params).max() <= 1e-6
        # the clients' training: at most one counted apart for a discrete
        # decision; without one the server state within the bounds
        counted = _counted_clients(cfg, r_c, p_c)
        counted_all.append([r_c[i].client for i in counted])
        assert len(counted) <= MAX_COUNTED, (rnd, counted)
        if not counted:
            diff = _diffs(port_srv.params, ref_srv.params)
            flips = int(np.sum(diff > gain * cfg.step_size * 1.01))
            assert flips <= MAX_FLIPS and int(np.sum(diff > 1e-6)) <= \
                MAX_OFF, (rnd, flips)
            assert _diffs(port_srv.scales, ref_srv.scales).max() <= (
                cfg.fine_step_size * 1.01)
            assert abs(p.test_acc - r.test_acc) <= 1 / n_test + 1e-6
    print(f"{name}: clients counted apart per aggregation {counted_all}")
    assert max(staleness) >= 1
    if ref_s.dispatch_window > 0:
        assert max(port.scheduler.batch_sizes) > 1
        assert stacked and max(stacked) > 1     # mixed server versions
    else:
        assert set(port.scheduler.batch_sizes) == {1} and not stacked


def test_async_dispatch_downloads_the_current_broadcast(monkeypatch):
    """``async_b4_fsfl`` with a channel (no drops) and bidirectional
    compression: every dispatch's download leg reads
    ``broadcast_ref_bytes``, the raw model until the first aggregation and
    then the last compressed broadcast, as the reference's does; the
    schedule (clients, staleness, participants) is the reference's, and
    ``sim_time_s`` within 2% of it (arrivals add the port's own upload
    times)."""
    chan = dict(up_mbps=4.0, down_mbps=16.0, latency_s=0.02,
                bandwidth_sigma=0.5)
    ref_s = dataclasses.replace(
        ref_scenarios.get_scenario("async_b4_fsfl"), bidirectional=True,
        channel=ref_scenarios.ChannelConfig(**chan))
    port_s = dataclasses.replace(
        scenarios.get_scenario("async_b4_fsfl"), bidirectional=True,
        channel=comms.ChannelConfig(**chan))
    reads = {"ref": [], "port": []}

    def spy_on(cls, log):
        down0 = cls.down_time

        def down_time(self, client, nbytes, round_idx=0):
            log.append((client, nbytes))
            return down0(self, client, nbytes, round_idx)

        monkeypatch.setattr(cls, "down_time", down_time)

    from repro.comms import channel as ref_channel
    from repro_torch.comms import channel as port_channel
    spy_on(ref_channel.ChannelModel, reads["ref"])
    spy_on(port_channel.ChannelModel, reads["port"])
    (cfg, ref, port, ref_recs, ref_servers, port_recs, port_servers,
     ref_log, port_log, n_test, _) = async_runs(ref_s, port_s, 2,
                                                resync=False)
    raw = 4 * sum(v.size for _, v in sorted_items(ref_servers[0].params))
    assert port._raw_model_bytes == raw
    for (r_c, _, _), (p_c, _, _) in zip(ref_log, port_log):
        assert [c.client for c in p_c] == [c.client for c in r_c]
        assert [c.staleness for c in p_c] == [c.staleness for c in r_c]
    for r, p in zip(ref_recs, port_recs):
        assert p.participants == r.participants
        assert abs(p.sim_time_s - r.sim_time_s) <= 0.02 * r.sim_time_s
        assert p.down_bytes > 0
    # the reads: the raw model for the 4 first dispatches and the 3
    # replacements before the first aggregation, then the compressed
    # broadcast (the last window's replacement waits for the server step)
    for who in ("ref", "port"):
        got = [n for _, n in reads[who]]
        assert got[:7] == [raw] * 7, who
        assert got[7:] and all(n < raw for n in got[7:]), who
    assert [c for c, _ in reads["port"]] == [c for c, _ in reads["ref"]]
    for (_, a), (_, b) in zip(reads["port"], reads["ref"]):
        assert abs(a - b) <= 0.02 * b


def test_async_validation_is_the_reference():
    cases = [
        dict(mode="async", sampling=dict(cohort_size=4)),
        dict(mode="async", channel=dict(drop_rate=0.1)),
        dict(mode="sync", async_cfg=dict(dispatch_window=0.5)),
        dict(mode="async", async_cfg=dict(dispatch_window=-1.0)),
    ]
    from repro.comms import ChannelConfig as RefChannel
    from repro.fl import engine as ref_engine
    from repro.fl.sampling import SamplingConfig as RefSampling
    for case in cases:
        def build(m, chan, samp, acfg):
            kw = {"mode": case["mode"]}
            if "sampling" in case:
                kw["sampling"] = samp(**case["sampling"])
            if "channel" in case:
                kw["channel"] = chan(**case["channel"])
            if "async_cfg" in case:
                kw["async_cfg"] = acfg(**case["async_cfg"])
            return m.EngineConfig(**kw)

        with pytest.raises(ValueError) as ref_err:
            build(ref_engine, RefChannel, RefSampling,
                  ref_async.AsyncConfig).validate(8)
        with pytest.raises(ValueError) as port_err:
            build(engine, comms.ChannelConfig, engine.SamplingConfig,
                  async_buffer.AsyncConfig).validate(8)
        assert str(port_err.value) == str(ref_err.value)
    # the adaptive window validates as the reference's
    for acfg, mode in ((dict(adaptive_window=True), "sync"),
                       (dict(adaptive_window=True, dispatch_window=0.5),
                        "async"),
                       (dict(adaptive_window=True, call_saving_s=-1.0),
                        "async")):
        with pytest.raises(ValueError) as ref_err:
            ref_engine.EngineConfig(
                mode=mode, async_cfg=ref_async.AsyncConfig(**acfg)
            ).validate(8)
        with pytest.raises(ValueError) as port_err:
            engine.EngineConfig(
                mode=mode, async_cfg=async_buffer.AsyncConfig(**acfg)
            ).validate(8)
        assert str(port_err.value) == str(ref_err.value)
    engine.EngineConfig(mode="async", async_cfg=async_buffer.AsyncConfig(
        adaptive_window=True)).validate(8)
