"""The port's population axis (``repro_torch.fl.population``, the
streaming sampler, the adaptive async window, ``metrics_out``) against the
reference's, on the CPU:

* the stores: spill, reload and cold-template behaviour; the in-memory
  and the sharded store bitwise on a random sequence of gathers and
  scatters, the sharded one's counters the reference's on the same
  sequence; reloaded shards writable;
* ``stream_cohort`` ids equal to the reference's (exclude, accept,
  weights, non-strict draws, the small-population full draw), the
  virtual view's base map and rows, and every traffic draw, bitwise;
* ``load_call_saving`` against the reference's on a temporary file, and
  the population axes' validation with the reference's messages;
* through the port's engine: the memory and the sharded store bit for bit
  for a sync cohort and for async (spilling every round), a virtual
  population end to end, total churn as all-drop rounds, and
  ``metrics_out`` lines the reference's sink writes for the same
  snapshot;
* teacher-forced parity with the reference's live runs (the small setting
  of ``test_torch_async``): a sync streaming run with diurnal traffic and
  churn, and ``churn_midround_async`` with an explicit ``call_saving_s``.
  Cohorts, churn events, window sizes and ``sim_time_s`` exactly the
  reference's; client updates under the same contract as the async tests
  (at most one client an aggregation counted apart for a discrete
  decision, the others within 34 params off by more than 1e-6 and their
  payload bytes within 2%).
"""
import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.fl import async_buffer as ref_async
from repro.fl import engine as ref_engine
from repro.fl import population as ref_pop
from repro.fl import rounds as ref_rounds
from repro.fl import sampling as ref_sampling
from repro.fl import scenarios as ref_scenarios
from repro.fl.engine import FederatedEngine as RefEngine
from repro.models import cnn as ref_cnn
from repro.obs import metrics as ref_metrics
from repro_torch import convert
from repro_torch.fl import async_buffer, engine, population, rounds
from repro_torch.fl import sampling, scenarios
from repro_torch.obs import metrics as obs_metrics
from repro_torch.tree import items, sorted_items
from test_torch_async import _counted_clients, _port_setting, _spy_aggregate


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())


# ------------------------------------------------------------- stores

def _template():
    gen = torch.Generator().manual_seed(0)
    return {"residual": torch.randn((3, 4), generator=gen),
            "step": torch.zeros((), dtype=torch.int32)}


def _rows(template, ids):
    """Distinct per-client rows from the ids (tensors)."""
    ids = torch.as_tensor(np.asarray(ids))
    return {"residual": template["residual"][None]
            + ids[:, None, None].to(torch.float32),
            "step": ids.to(torch.int32)}


def _sharded(n, size, hot):
    return population.ShardedLazyStore(_template(), n, population.StoreConfig(
        backend="sharded", shard_size=size, max_hot_shards=hot))


def test_sharded_spill_reload_roundtrip():
    tpl, store = _template(), _sharded(64, 4, 2)
    ids = np.arange(0, 64, 2)           # all 16 shards: spills
    store.scatter(ids, _rows(tpl, ids))
    assert store.stats()["spills"] > 0 and store.stats()["max_hot_seen"] <= 2
    got, want = store.gather(ids), _rows(tpl, ids)
    assert isinstance(got["step"], torch.Tensor)
    assert torch.equal(got["step"], want["step"])
    assert torch.equal(got["residual"], want["residual"])
    assert store.stats()["loads"] > 0
    store.close()


def test_sharded_reloaded_shards_are_writable():
    tpl, store = _template(), _sharded(32, 4, 1)
    store.scatter([0], _rows(tpl, [0]))
    store.scatter([10], _rows(tpl, [10]))   # shard 0 to disk
    store.scatter([1], _rows(tpl, [1]))     # shard 0 back, written in place
    assert store.gather([0, 1])["step"].tolist() == [0, 1]
    assert all(leaf.flags.writeable for leaf in store._hot[0])
    store.close()


def test_sharded_cold_clients_serve_the_template():
    tpl, store = _template(), _sharded(1000, 8, 2)
    got = store.gather([3, 977])
    for path, leaf in items(got):
        for r in leaf:
            assert torch.equal(r, dict(items(tpl))[path])
    stats = store.stats()
    assert stats["cold_gathers"] == 2 and stats["materializations"] == 0
    store.close()


def test_memory_and_sharded_bitwise_on_random_operations():
    """The same random gathers and scatters through the in-memory store,
    the sharded store and the reference's sharded store: the port's two
    bitwise equal, and the sharded lifecycle counters the reference's."""
    tpl = _template()
    ref_tpl = {k: v.numpy() for k, v in tpl.items()}
    mem = population.InMemoryStore(tpl, 48)
    shd = _sharded(48, 4, 2)
    ref = ref_pop.ShardedLazyStore(ref_tpl, 48, ref_pop.StoreConfig(
        backend="sharded", shard_size=4, max_hot_shards=2))
    rng = np.random.default_rng(0)
    for _ in range(16):
        ids = rng.choice(48, size=5, replace=False)
        if rng.random() < 0.6:
            rows = _rows(tpl, ids + rng.integers(0, 100))
            mem.scatter(ids, rows)
            shd.scatter(ids, rows)
            ref.scatter(ids, {k: v.numpy() for k, v in rows.items()})
        a, b, r = mem.gather(ids), shd.gather(ids), ref.gather(ids)
        for p, leaf in items(a):
            assert _bits(leaf.numpy(), dict(items(b))[p].numpy()), p
            assert _bits(leaf.numpy(), r[p]), p
        assert shd.stats() == ref.stats()
    assert shd.stats()["spills"] > 0 and shd.stats()["loads"] > 0
    shd.close()
    with pytest.raises(ValueError, match="unknown store backend"):
        population.make_store(population.StoreConfig(backend="disk"), tpl, 4)
    for bad in (dict(shard_size=0), dict(max_hot_shards=0),
                dict(backend="x")):
        with pytest.raises(ValueError) as port_err:
            population.StoreConfig(**bad).validate()
        with pytest.raises(ValueError) as ref_err:
            ref_pop.StoreConfig(**bad).validate()
        assert str(port_err.value) == str(ref_err.value)


# ------------------------------------------------------------- streaming

STREAM_CASES = {
    "plain": dict(seed=7, rnd=3, n=10**6, k=32),
    "exclude": dict(seed=1, rnd=0, n=10**5, k=16,
                    exclude=set(range(0, 10**5, 2))),
    "accept": dict(seed=1, rnd=2, n=10**5, k=16,
                   accept=lambda ids: np.asarray(ids) % 3 == 0),
    "weights": dict(seed=5, rnd=4, n=10**4, k=16,
                    weight=lambda ids: np.where(np.asarray(ids) < 500, 1.0,
                                                0.02)),
    "thin_non_strict": dict(seed=3, rnd=1, n=10**3, k=40, strict=False,
                            accept=lambda ids: np.asarray(ids) < 30),
    "full_small": dict(seed=2, rnd=0, n=8, k=8),
    "full_small_exclude": dict(seed=2, rnd=0, n=8, k=8, exclude={1, 5},
                               accept=lambda ids: np.asarray(ids) != 3),
    "empty": dict(seed=2, rnd=0, n=8, k=0),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_cohort_ids_equal_the_reference(case):
    c = STREAM_CASES[case]
    kw = dict(weight_fn=c.get("weight"), accept_fn=c.get("accept"),
              exclude=c.get("exclude", ()), strict=c.get("strict", True))
    got = sampling.stream_cohort(c["seed"], c["rnd"], c["n"], c["k"], **kw)
    want = ref_sampling.stream_cohort(c["seed"], c["rnd"], c["n"], c["k"],
                                      **kw)
    assert _bits(got, want)
    assert len(set(got.tolist())) == len(got)
    with pytest.raises(RuntimeError, match="acceptable clients"):
        sampling.stream_cohort(3, 1, 10**3, 40, max_blocks=2,
                               accept_fn=lambda ids: np.asarray(ids) < 30)


def test_traffic_draws_bitwise():
    cfg = dict(diurnal=population.DIURNAL_DEFAULT, day_s=240.0,
               timezone_spread=0.3, availability=0.8, churn_rate=0.2,
               latency_mean=2.0, seed=11)
    tm = population.TrafficModel(population.TrafficConfig(**cfg))
    ref = ref_pop.TrafficModel(ref_pop.TrafficConfig(**cfg))
    ids = np.arange(0, 50_000, 37)
    assert _bits(tm.device_class(ids), ref.device_class(ids))
    for now in (0.0, 37.0, 119.9, 1000.5):
        assert _bits(tm.rate(now, ids), ref.rate(now, ids))
        assert tm.rate(now) == ref.rate(now)
        for rnd in (0, 3):
            assert _bits(tm.available(ids, now, rnd),
                         ref.available(ids, now, rnd))
    for c in range(0, 5000, 97):
        assert tm.latency(c) == ref.latency(c)
        for d in range(4):
            assert tm.churned(c, d) == ref.churned(c, d)
            assert tm.churn_time(c, d) == ref.churn_time(c, d)
    flat = population.TrafficModel(population.TrafficConfig())
    assert flat.available(np.arange(100), 0.0, 0).all()
    assert population.TRAFFIC_PRESETS.keys() == ref_pop.TRAFFIC_PRESETS.keys()
    for name, p in population.TRAFFIC_PRESETS.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(
            ref_pop.TRAFFIC_PRESETS[name])
    bad = [dict(diurnal=(1.0,)), dict(diurnal=(0.0, 0.0)), dict(day_s=0.0),
           dict(availability=0.0), dict(timezone_spread=1.5),
           dict(churn_rate=1.5), dict(latency_mean=0.0),
           dict(classes=(population.DeviceClass("a", 0.5),))]
    for b in bad:
        ref_b = dict(b)
        if "classes" in b:
            ref_b["classes"] = (ref_pop.DeviceClass("a", 0.5),)
        with pytest.raises(ValueError) as port_err:
            population.TrafficConfig(**b).validate()
        with pytest.raises(ValueError) as ref_err:
            ref_pop.TrafficConfig(**ref_b).validate()
        assert str(port_err.value) == str(ref_err.value)


def test_virtual_view_maps_as_the_reference():
    model, splits, ref_splits = _port_setting()
    view = population.make_view(splits, 1000, seed=3)
    ref = ref_pop.make_view(ref_splits, 1000, seed=3)
    idx = np.array([0, 17, 999, 17, 512])
    assert _bits(view.base_index(idx), ref.base_index(idx))
    for got, want in zip(view.gather(idx), ref.gather(idx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not view.dense and population.make_view(splits, None).dense
    assert population.make_view(splits, splits.num_clients).dense
    with pytest.raises(RuntimeError, match="virtual"):
        view.all()
    with pytest.raises(ValueError, match="must be >="):
        population.make_view(splits, 3)


def test_load_call_saving_as_the_reference(tmp_path):
    bench = {"async": {"concurrency": 4, "no_wire": {
        "serial_completions": {"steady_agg_s": 2.0},
        "windowed": {"steady_agg_s": 1.0, "batch_sizes": [2, 3, 2]}}}}
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    assert async_buffer.load_call_saving(str(path)) == (
        ref_async.load_call_saving(str(path)))
    assert async_buffer.load_call_saving(str(path)) == pytest.approx(
        1.0 / 4 / (1 - 3 / 7))
    for broken in ({"async": {}}, {"async": {
            "concurrency": 4, "no_wire": {
                "serial_completions": {"steady_agg_s": 1.0},
                "windowed": {"steady_agg_s": 2.0, "batch_sizes": [2]}}}}):
        path.write_text(json.dumps(broken))
        assert async_buffer.load_call_saving(str(path), 0.123) == 0.123
        with warnings.catch_warnings():     # the reference warns once
            warnings.simplefilter("ignore", RuntimeWarning)
            assert ref_async.load_call_saving(str(path), 0.123) == 0.123
    assert async_buffer.load_call_saving(str(tmp_path / "none.json"),
                                         default=0.07) == 0.07
    # the port looks for no file of its own: BENCH_cohort.json is a JAX
    # run on a CPU, not a measurement of the port
    assert async_buffer.load_call_saving() == 0.05


def test_population_validation_is_the_reference():
    cases = [dict(population=0, sampling=dict(cohort_size=4)),
             dict(population=100),
             dict(traffic=dict(churn_rate=2.0)),
             dict(store=dict(shard_size=0)),
             dict(metrics_out="m.jsonl")]
    for case in cases:
        def build(eng, samp, pop):
            kw = {}
            if "population" in case:
                kw["population"] = case["population"]
            if "sampling" in case:
                kw["sampling"] = samp(**case["sampling"])
            if "traffic" in case:
                kw["traffic"] = pop.TrafficConfig(**case["traffic"])
            if "store" in case:
                kw["store"] = pop.StoreConfig(**case["store"])
            if "metrics_out" in case:
                kw["metrics_out"] = case["metrics_out"]
            return eng.EngineConfig(**kw)

        with pytest.raises(ValueError) as ref_err:
            build(ref_engine, ref_sampling.SamplingConfig,
                  ref_pop).validate(8)
        with pytest.raises(ValueError) as port_err:
            build(engine, sampling.SamplingConfig, population).validate(8)
        assert str(port_err.value) == str(ref_err.value)
    engine.EngineConfig(population=100, sampling=sampling.SamplingConfig(
        cohort_size=4)).validate(100)
    engine.EngineConfig(mode="async", population=100).validate(100)


# ------------------------------------------------------------- engine

def _protocol():
    from repro_torch.core.protocol import ProtocolConfig
    return ProtocolConfig(name="eqs23", method="sparse", error_feedback=True,
                          fixed_sparsity=0.9, structured=False,
                          batch_size=32, local_lr=2e-3)


def _run(model, splits, rounds_, **ecfg):
    eng = engine.FederatedEngine(model, _protocol(), splits, seed=5,
                                 device="cpu",
                                 engine_cfg=engine.EngineConfig(**ecfg))
    return eng, eng.run(rounds_)


def _same_runs(a, b):
    (ea, ra), (eb, rb) = a, b
    assert [(r.up_bytes, r.test_acc, r.participants, r.sim_time_s)
            for r in ra.records] == [(r.up_bytes, r.test_acc, r.participants,
                                      r.sim_time_s) for r in rb.records]
    for part in ("params", "scales", "bn_state"):
        for (p, x), (_, y) in zip(sorted_items(getattr(ea.server, part)),
                                  sorted_items(getattr(eb.server, part))):
            assert torch.equal(x, y), p


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_memory_and_sharded_stores_identical_through_the_engine(mode):
    """The same run on the in-memory store and on the sharded store with
    one client a shard and one shard hot (a spill and a load nearly every
    gather): records and server bit for bit."""
    model, splits = scenarios.default_setting(4, n_samples=640)
    kw = (dict(sampling=sampling.SamplingConfig(cohort_size=2))
          if mode == "sync" else dict(mode="async",
                                      async_cfg=async_buffer.AsyncConfig(
                                          buffer_size=2, concurrency=3)))
    runs = {b: _run(model, splits, 3, store=population.StoreConfig(
        backend=b, shard_size=1, max_hot_shards=1), **kw)
        for b in ("memory", "sharded")}
    _same_runs(runs["memory"], runs["sharded"])
    stats = runs["sharded"][0].local_train.store.stats()
    assert stats["spills"] > 0 and stats["loads"] > 0, stats


def test_virtual_population_end_to_end():
    """A virtual population larger than the data shards streams its
    cohorts through the sharded store, with mid-round churn; participants
    are virtual ids, a churned client's decoded delta goes back into its
    residual in the sharded store (a gather and a scatter of its row), and
    the memory store gives the same run bit for bit."""
    model, splits = scenarios.default_setting(2, n_samples=640)
    kw = dict(sampling=sampling.SamplingConfig(cohort_size=4),
              population=64,
              traffic=population.TrafficConfig(day_s=240.0, availability=0.9,
                                               churn_rate=0.3, seed=2))
    sharded = _run(model, splits, 3, store=population.StoreConfig(
        backend="sharded", shard_size=4, max_hot_shards=2), **kw)
    eng, res = sharded
    parts = {c for r in res.records for c in r.participants}
    assert len(parts) > 2 and max(parts) >= 2
    assert eng.scheduler.churned_total > 0
    assert any(len(r.participants) < 4 for r in res.records)
    assert res.records[-1].sim_time_s > 0
    _same_runs(sharded, _run(model, splits, 3, **kw))


def test_async_full_churn_completes_as_all_drop():
    """Churn 1: every dispatch vanishes before its upload; the bounded
    retry surfaces all-drop rounds and the run ends."""
    model, splits = scenarios.default_setting(2, n_samples=640)
    eng, res = _run(model, splits, 2, mode="async",
                    async_cfg=async_buffer.AsyncConfig(buffer_size=2,
                                                       concurrency=2),
                    traffic=population.TrafficConfig(churn_rate=1.0,
                                                     seed=5))
    assert len(res.records) == 2
    assert all(r.participants == () for r in res.records)
    assert all(r.up_bytes == 0 and r.down_bytes == 0 for r in res.records)
    assert eng.scheduler.churned_total > 2000


def test_metrics_out_lines_equal_the_reference(tmp_path):
    snap = {"counters": {"uplink.bytes": 1234, "rounds": 1},
            "counters_total": {"uplink.bytes": 5678, "rounds": 3},
            "gauges": {"store.spills": 2, "round.wall_s": 0.25},
            "histograms": {"async.batch_size": {"n": 2, "mean": 1.5}}}
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("port", "ref")}
    for sink in (obs_metrics.MetricsJsonlSink(paths["port"]),
                 ref_metrics.MetricsJsonlSink(paths["ref"])):
        sink.write(1, snap)
        sink.write(2, {**snap, "gauges": {}})
        sink.close()
    lines = {k: open(p).read() for k, p in paths.items()}
    assert lines["port"] == lines["ref"] and lines["port"].count("\n") == 2
    # through the engine: one line a round, the record's bytes and the
    # store's gauges
    model, splits = scenarios.default_setting(2, n_samples=640)
    out = str(tmp_path / "run.jsonl")
    _, res = _run(model, splits, 2, telemetry="metrics", metrics_out=out,
                  sampling=sampling.SamplingConfig(cohort_size=2),
                  population=16, store=population.StoreConfig(
                      backend="sharded", shard_size=4, max_hot_shards=1))
    got = [json.loads(line) for line in open(out)]
    assert [g["round"] for g in got] == [1, 2]
    for g, r in zip(got, res.records):
        assert g["counters"]["uplink.bytes"] == r.up_bytes
        assert g == {"round": r.round, **r.telemetry}
        assert {"store.spills", "store.loads", "store.materializations",
                "store.cold_gathers"} <= set(g["gauges"])


# ------------------------------------------------------------- parity

ROUNDS = 2
CHURN_SYNC = dict(diurnal=population.DIURNAL_DEFAULT, day_s=240.0,
                  timezone_spread=0.25, latency_mean=2.0, churn_rate=0.5,
                  seed=3)


def _bytes_close(r_c, p_c, counted) -> None:
    """The payload bytes of the clients not counted apart within 2% of the
    reference's (a counted client took another discrete decision, and on
    this model's 1.2 kB payloads one such client moves a round's total by
    up to 4%)."""
    keep = [i for i in range(len(r_c)) if i not in counted]
    want = sum(r_c[i].payload_bytes for i in keep)
    assert abs(sum(p_c[i].payload_bytes for i in keep) - want) <= 0.02 * want


def _ref_vgg():
    return ref_cnn.make_vgg("vgg_scenario", [8, 16, 32], 10, 3,
                            dense_width=16, pool_after=(0, 1, 2))


def test_sync_streaming_run_teacher_forced_matches_reference():
    """``pop_100k_diurnal``'s axes on the small setting: 24 virtual
    clients over the 8 base shards (the memory store, whose whole state
    the port takes from the reference's each round), cohorts of 4 drawn
    by the hash stream under diurnal availability, 50% mid-round churn.
    Each port round starts from the reference's state after the round
    before.  The streamed cohorts (the port raises on a planned cohort
    that differs), the churned clients (no bytes), the participants and
    ``sim_time_s`` are exactly the reference's; the updates within the
    async tests' contract."""
    def scenario(mod, traffic):
        s = mod.get_scenario("pop_100k_diurnal")
        return dataclasses.replace(s, population=24, store="memory",
                                   cohort_size=4, traffic=traffic)

    ref_s = scenario(ref_scenarios, ref_pop.TrafficConfig(**CHURN_SYNC))
    port_s = scenario(scenarios, population.TrafficConfig(**CHURN_SYNC))
    model, splits, ref_splits = _port_setting()
    cfg = ref_scenarios.build_protocol(ref_s, ROUNDS)
    cohorts, plan = [], []
    select0 = ref_rounds.CohortPlan.select_stream
    batches0 = ref_rounds.client_epoch_batches

    def select_stream(self, round_idx, now):
        out = select0(self, round_idx, now)
        cohorts.append(np.asarray(out))
        return out

    def client_epoch_batches(*a):
        # the round's cohort is the streamed draw just before its batches
        out = batches0(*a)
        plan.append((cohorts[-1], np.asarray(out)))
        return out

    ref_log, ref_recs, ref_states = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_rounds.CohortPlan, "select_stream", select_stream)
        mp.setattr(ref_rounds, "client_epoch_batches", client_epoch_batches)
        ref = RefEngine(_ref_vgg(), cfg, ref_splits, jax.random.PRNGKey(42),
                        ref_scenarios.build_engine(ref_s))
        server0 = jax.device_get(ref.server)
        pers0 = jax.device_get(jax.tree.map(lambda x: x[0],
                                            ref.local_train.persistent))
        _spy_aggregate(ref, ref_log)
        for _ in range(ROUNDS):
            ref_recs += ref.run(1).records
            ref_states.append(jax.device_get(
                (ref.server, ref.server_step.state,
                 ref.local_train.persistent)))
    port = engine.FederatedEngine(
        model, scenarios.build_protocol(port_s, ROUNDS), splits,
        engine_cfg=scenarios.build_engine(port_s),
        init_state=convert.initial_state(server0, pers0), plan=plan,
        device="cpu")
    port_log, port_recs = [], []
    _spy_aggregate(port, port_log)
    for rnd in range(ROUNDS):
        if rnd:
            server, opt_state, pers = ref_states[rnd - 1]
            port.server = convert.server_state(server)
            port.server_step.state = convert.optimizer_state(opt_state)
            port.local_train.state = convert.client_persistent(pers)
        port_recs += port.run(1).records
    assert port.scheduler.churned_total == ref.scheduler.churned_total > 0
    assert port.scheduler.sim_clock == ref.scheduler.sim_clock
    for (r_c, _, _), (p_c, _, _), r, p in zip(ref_log, port_log, ref_recs,
                                              port_recs):
        assert p.participants == r.participants
        assert p.sim_time_s == r.sim_time_s
        assert [c.client for c in p_c] == [c.client for c in r_c]
        counted = _counted_clients(cfg, r_c, p_c)
        assert len(counted) <= 1
        _bytes_close(r_c, p_c, counted)
    # churned clients were lost: in the cohort, not among the participants
    assert any(len(r.participants) < 4 for r in ref_recs)


def _materialized(store) -> np.ndarray:
    sids = sorted(set(store._hot) | set(store._spilled))
    size = store.cfg.shard_size
    return np.concatenate([np.arange(s * size, min((s + 1) * size,
                                                   store.num_clients))
                           for s in sids]) if sids else np.empty(0, int)


def test_churn_midround_async_teacher_forced_matches_reference():
    """``churn_midround_async`` (10^4 virtual clients over the 8 base
    shards, the sharded store, 15% churn keyed by dispatch, adaptive
    windows) with ``call_saving_s`` = 0.05 given to both: the reference's
    batch orders handed over, each port aggregation from the reference's
    state (server, optimizer, every materialized client's state, the
    in-flight snapshots by version).  Window sizes, churn count, buffer
    clients, staleness, arrival times, weights (bitwise) and the clock
    exactly the reference's; the updates within the contract."""
    def build(mod, s):
        e = mod.build_engine(s)
        return dataclasses.replace(e, async_cfg=dataclasses.replace(
            e.async_cfg, call_saving_s=0.05))

    ref_s = ref_scenarios.get_scenario("churn_midround_async")
    port_s = scenarios.get_scenario("churn_midround_async")
    model, splits, ref_splits = _port_setting()
    cfg = ref_scenarios.build_protocol(ref_s, ROUNDS)
    batches = []
    batches0 = ref_rounds.epoch_batches

    def epoch_batches(*a):
        out = batches0(*a)
        batches.append(np.asarray(out))
        return out

    ref_log, ref_recs, ref_states = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_rounds, "epoch_batches", epoch_batches)
        ref = RefEngine(_ref_vgg(), cfg, ref_splits, jax.random.PRNGKey(42),
                        build(ref_scenarios, ref_s))
        server0 = jax.device_get(ref.server)
        pers0 = jax.device_get(ref.local_train.store._template_leaves)
        pers0 = jax.tree.unflatten(ref.local_train.store._treedef, pers0)
        _spy_aggregate(ref, ref_log)
        for _ in range(ROUNDS):
            ref_recs += ref.run(1).records
            store = ref.local_train.store
            ids = _materialized(store)
            ref_states.append((jax.device_get(ref.server),
                               jax.device_get(ref.server_step.state), ids,
                               store.gather(ids) if len(ids) else None))
    plan = rounds.AsyncPlan(latencies=None, draws=[], batches=batches,
                            lat_seed=ref.scheduler.lat_seed)
    port = engine.FederatedEngine(
        model, scenarios.build_protocol(port_s, ROUNDS), splits,
        engine_cfg=build(scenarios, port_s),
        init_state=convert.initial_state(server0, pers0), plan=plan,
        device="cpu")
    port_log, port_recs = [], []
    _spy_aggregate(port, port_log)
    versions = {0: port.server}
    for rnd in range(ROUNDS):
        if rnd:
            server, opt_state, ids, rows_ = ref_states[rnd - 1]
            versions[rnd] = port.server = convert.server_state(server)
            port.server_step.state = convert.optimizer_state(opt_state)
            if rows_ is not None:
                port.local_train.store.scatter(
                    ids, convert.client_persistent(rows_))
            for e in port.scheduler.in_flight:
                e.server = versions[e.start_version]
        port_recs += port.run(1).records
    sch, ref_sch = port.scheduler, ref.scheduler
    assert sch.saving == ref_sch.saving == 0.05
    assert sch.batch_sizes == ref_sch.batch_sizes
    assert sch.churned_total == ref_sch.churned_total > 0
    assert sch.now == ref_sch.now and sch.seq == ref_sch.seq
    assert sch.draws == ref_sch.draws and sch.busy == ref_sch.busy
    for (r_c, r_w, _), (p_c, p_w, _), r, p in zip(ref_log, port_log,
                                                  ref_recs, port_recs):
        assert [c.client for c in p_c] == [c.client for c in r_c]
        assert [c.staleness for c in p_c] == [c.staleness for c in r_c]
        assert [c.arrival_time for c in p_c] == [c.arrival_time
                                                 for c in r_c]
        assert _bits(p_w, r_w)
        assert p.participants == r.participants
        assert p.sim_time_s == r.sim_time_s
        counted = _counted_clients(cfg, r_c, p_c)
        assert len(counted) <= 1
        _bytes_close(r_c, p_c, counted)
