"""The host uplink in the port against the reference: the uplink pools,
batched CABAC, streaming ingest and the ``obs`` telemetry they report
through.

* ``StreamingIngest`` over a cohort of nnc-cabac payloads (made by the
  reference's codec, byte-equal to the port's): its weighted mean bitwise
  the port's gather fold (``weighted_mean_trees`` over the decoded trees)
  and the reference's own ingest, inline, threaded and with the
  speculative decoder, at every chunk size; schema v2's BN section; at
  most ``chunk`` decoded trees resident; a corrupt payload quarantined
  alone, the rest folded as if it had never been sent.  The sync plain
  mean: the float64 fold equals the gather's float32 ``torch.mean`` for
  two contributions and lies within an ulp of it for eight (the
  reference's own fold within two of its ``jnp.mean``).
* The six scenarios against the live reference, each client's training
  teacher-forced from the reference's outputs (the five sync ones, 2
  rounds on the port's tiny setting): ``up_bytes`` equal every round; the
  streaming scenarios' server params and scales bitwise the reference's
  (the same float64 fold, the same FedAvg step), the pooled ones' within
  2 ulps, as the gather path is held.  ``stream_ingest_async_b4`` along the
  reference's draws: its schedule exactly the reference's and its bytes
  within 2%, as the other async scenarios.
* In the port: every pooled scenario's payloads, and a thread-pooled
  int8-blockscale uplink's (a device coder: threads, never processes),
  byte-identical to the serial uplink's (sizes and decoded trees of every
  contribution, the server bitwise), with the pool's task count; the async streaming server
  bitwise the async gather server over the same run; a corrupt payload in
  a streaming round quarantined alone, its client's reconstruction back
  in its residual.
* ``obs``: telemetry ``"off"`` records nothing and allocates nothing; on
  the same scenarios the counter, gauge and histogram names equal the
  reference's, the event counts equal, and the byte counters equal each
  record's bytes.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comms as ref_comms
from repro.core import quant as ref_quant
from repro.fl import TreeAccumulator as RefAccumulator
from repro.fl import rounds as ref_rounds
from repro.fl import scenarios as ref_scenarios
from repro.fl.engine import FederatedEngine as RefEngine
from repro.fl.ingest import IngestConfig as RefIngestConfig
from repro.fl.ingest import StreamingIngest as RefIngest
from repro.models import cnn as ref_cnn
from repro_torch import comms, convert, obs
from repro_torch.fl import async_buffer, engine, rounds, scenarios
from repro_torch.fl.ingest import IngestConfig, StreamingIngest
from repro_torch.tree import sorted_items
from test_torch_async import N_SAMPLES, _port_setting, async_runs
from test_torch_cnn_families import round_output


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree) -> dict:
    return {p: np.asarray(v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else v)
            for p, v in sorted_items(tree)}


def _bitwise(got, want) -> None:
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for p, v in want.items():
        a = np.atleast_1d(got[p])
        b = np.atleast_1d(np.asarray(v, a.dtype))
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=p)


def _ulps(got, want) -> float:
    got, want = _flat(got), _flat(want)
    worst = 0.0
    for p, v in want.items():
        v = np.asarray(v, np.float32)
        diff = np.abs(got[p].astype(np.float64) - v) / np.spacing(np.abs(v))
        worst = max(worst, float(diff.max(initial=0.0)))
    return worst


# ---------------------------------------------------------------- cohorts

_SHAPES = {"conv": {"w": (6, 4, 3, 3), "b": (6,)}, "fc": {"w": (5, 24)}}
_SCALE_SHAPES = {"s0": (6,), "s1": (5,)}


def _tree_of(fn, node):
    if isinstance(node, dict):
        return {k: _tree_of(fn, v) for k, v in node.items()}
    return fn(node)


def _cohort(k: int, seed: int = 0, version: int = 1):
    """K updates coded by the reference's and the port's nnc-cabac (equal
    bytes asserted) -> (port payloads, port spec, reference spec)."""
    q = ref_quant.QuantConfig()
    fine = _tree_of(lambda s: len(s) < 2, _SHAPES)
    ref_spec = ref_comms.WireSpec(
        params=_tree_of(lambda s: jax.ShapeDtypeStruct(s, np.float32),
                        _SHAPES),
        scales=_tree_of(lambda s: jax.ShapeDtypeStruct(s, np.float32),
                        _SCALE_SHAPES),
        fine_mask=fine, step_size=q.step_size,
        fine_step_size=q.fine_step_size,
        bn=({"m": jax.ShapeDtypeStruct((7,), np.float32)}
            if version == 2 else None), version=version)
    port_spec = comms.WireSpec(
        params=_tree_of(lambda s: comms.LeafSpec(s), _SHAPES),
        scales=_tree_of(lambda s: comms.LeafSpec(s), _SCALE_SHAPES),
        fine_mask=fine, step_size=q.step_size,
        fine_step_size=q.fine_step_size,
        bn=({"m": comms.LeafSpec((7,))} if version == 2 else None),
        version=version)
    payloads = []
    for i in range(k):
        rng = np.random.default_rng(seed * 100 + i)
        lv = _tree_of(lambda s: (rng.integers(-9, 10, s)
                                 * (rng.random(s) < 0.35)).astype(np.int32),
                      _SHAPES)
        recon = jax.tree.map(
            lambda l, f: l.astype(np.float32)
            * np.float32(q.fine_step_size if f else q.step_size), lv, fine)
        s_lv = _tree_of(lambda s: rng.integers(-3, 4, s).astype(np.int32),
                        _SCALE_SHAPES)
        s_recon = jax.tree.map(lambda l: l.astype(np.float32)
                               * np.float32(q.fine_step_size), s_lv)
        bn = ({"m": rng.normal(size=(7,)).astype(np.float32)}
              if version == 2 else None)
        ref_payload = ref_comms.get_codec("nnc-cabac").encode(
            ref_comms.ClientUpdate(lv, s_lv, recon, s_recon, bn=bn), ref_spec)
        port_payload = comms.get_codec("nnc-cabac").encode(
            comms.ClientUpdate(lv, s_lv, recon, s_recon, bn=bn), port_spec)
        assert port_payload == ref_payload
        payloads.append(port_payload)
    return payloads, port_spec, ref_spec


def _ingest(payloads, spec, cfg, weights=None):
    ing = StreamingIngest(comms.get_codec("nnc-cabac"), spec, cfg)
    for i, p in enumerate(payloads):
        ing.submit(i, p, weight=1.0 if weights is None else weights[i])
    return ing.finish()


W6 = [0.5, 1.0, 2.0, 0.25, 1.5, 0.75]


@pytest.mark.parametrize("cfg", [
    IngestConfig(chunk=1), IngestConfig(chunk=4),
    IngestConfig(chunk=8, workers=2), IngestConfig(chunk=2, workers=3),
    IngestConfig(chunk=4, decode_engine="speculative"),
    IngestConfig(chunk=3, workers=2, decode_engine="serial")])
def test_ingest_fold_bitwise_gather_and_reference(cfg):
    payloads, spec, ref_spec = _cohort(6)
    res = _ingest(payloads, spec, cfg, W6)
    assert res.accepted == 6 and not res.rejected
    assert res.stats.max_resident <= cfg.chunk
    decs = comms.get_codec("nnc-cabac").decode_batch(payloads, spec)
    for part in ("params", "scales"):
        gather = async_buffer.weighted_mean_trees(
            [getattr(d, part) for d in decs], np.array(W6), host=True)
        _bitwise(getattr(res, f"delta_{part}"), gather)
    ing = RefIngest(ref_comms.get_codec("nnc-cabac"), ref_spec,
                    RefIngestConfig(chunk=cfg.chunk, workers=cfg.workers,
                                    decode_engine=cfg.decode_engine))
    for i, p in enumerate(payloads):
        ing.submit(i, p, weight=W6[i])
    want = ing.finish()
    _bitwise(res.delta_params, want.delta_params)
    _bitwise(res.delta_scales, want.delta_scales)
    assert res.weight_sum == want.weight_sum


def test_ingest_bn_section_under_schema_v2():
    payloads, spec, _ = _cohort(4, seed=3, version=2)
    res = _ingest(payloads, spec, IngestConfig(chunk=2), [1.0, 2.0, 1.0, 0.5])
    decs = comms.get_codec("nnc-cabac").decode_batch(payloads, spec)
    _bitwise(res.bn, async_buffer.weighted_mean_trees(
        [d.bn for d in decs], np.array([1.0, 2.0, 1.0, 0.5]), host=True))


def test_corrupt_payload_quarantined_alone():
    payloads, spec, _ = _cohort(6, seed=1)
    bad = bytearray(payloads[2])
    bad[:16] = b"\xff" * 16            # a length header past the stream
    res = _ingest(payloads[:2] + [bytes(bad)] + payloads[3:], spec,
                  IngestConfig(chunk=4, workers=2), W6)
    assert [r.seq for r in res.rejected] == [2] and res.accepted == 5
    assert "CorruptPayloadError" in res.rejected[0].error
    keep = [0, 1, 3, 4, 5]
    want = _ingest([payloads[i] for i in keep], spec, IngestConfig(chunk=4),
                   [W6[i] for i in keep])
    _bitwise(res.delta_params, want.delta_params)
    _bitwise(res.delta_scales, want.delta_scales)


def test_queue_depth_bounds_the_backlog():
    payloads, spec, _ = _cohort(8, seed=2)
    ing = StreamingIngest(comms.get_codec("nnc-cabac"), spec,
                          IngestConfig(chunk=2, queue_depth=2, workers=1))
    for i, p in enumerate(payloads):
        ing.submit(i, p)
        assert ing._pending() <= 2 + 2
    res = ing.finish()
    assert res.accepted == 8 and res.stats.max_resident <= 2
    with pytest.raises(RuntimeError):
        ing.submit(0, payloads[0])


@pytest.mark.parametrize("k", [2, 8])
def test_sync_plain_mean_fold_against_the_gather_mean(k):
    """The sync round's plain mean: the ingest's float64 fold against the
    gather path's float32 ``torch.mean`` of the same decoded trees, and the
    reference's fold against its ``jnp.mean``: bitwise for two; for eight
    the port's within an ulp and the reference's within two."""
    payloads, spec, ref_spec = _cohort(k, seed=4)
    res = _ingest(payloads, spec, IngestConfig(chunk=3))
    decs = comms.get_codec("nnc-cabac").decode_batch(payloads, spec)
    gather = rounds.tree_mean0(rounds.stack_trees(
        [d.params for d in decs], torch.device("cpu")))
    ref_acc = RefAccumulator()
    for d in decs:
        ref_acc.add(d.params, 1.0)
    ref_gather = jax.tree.map(lambda *ls: np.asarray(jnp.mean(
        jnp.stack(ls), axis=0)), *[d.params for d in decs])
    _bitwise(res.delta_params, ref_acc.mean())
    if k == 2:
        _bitwise(res.delta_params, gather)
        _bitwise(ref_acc.mean(), ref_gather)
    else:
        assert _ulps(res.delta_params, _flat(gather)) <= 1.0
        assert _ulps(ref_acc.mean(), _flat(ref_gather)) <= 2.0


def test_ingest_config_and_engine_validation_are_the_reference():
    for bad in (dict(chunk=0), dict(chunk=8, queue_depth=4),
                dict(workers=-1)):
        with pytest.raises(ValueError):
            IngestConfig(**bad).validate()
        with pytest.raises(ValueError):
            RefIngestConfig(**bad).validate()
    for bad in (dict(ingest="scatter"), dict(ingest="streaming",
                                             measure_bytes=False),
                dict(ingest="streaming", uplink_workers=2),
                dict(ingest_opts=IngestConfig(chunk=2)),
                dict(uplink_executor="fork"), dict(uplink_workers=-1),
                dict(telemetry="loud"),
                dict(mode="async", uplink_workers=2)):
        with pytest.raises(ValueError):
            engine.EngineConfig(**bad).validate()
    with pytest.raises(ValueError, match="metrics_out"):
        engine.EngineConfig(metrics_out="x.jsonl").validate()
    with pytest.raises(ValueError):     # a device codec in worker processes
        engine.FederatedEngine(
            *_port_setting()[:1], scenarios.build_protocol(
                scenarios.get_scenario("sync_full_fedavg_fsfl"), 1),
            _port_setting()[1], engine_cfg=engine.EngineConfig(
                codec="int8-blockscale", uplink_workers=2,
                uplink_executor="process"), device="cpu")


def test_other_scenarios_still_not_ported():
    assert sorted(scenarios.NOT_PORTED) == ["dist_cohort_full"]
    for name, item in scenarios.NOT_PORTED.items():
        with pytest.raises(NotImplementedError, match=item):
            scenarios.get_scenario(name)
    assert len(scenarios.SCENARIOS) == 34
    assert set(scenarios.SCENARIOS) | set(scenarios.NOT_PORTED) == set(
        ref_scenarios.list_scenarios())


# ---------------------------------------------------------------- whole runs

ROUNDS = 2
SYNC = ["uplink_pool_k8", "cabac_fast_batch_k8", "cabac_fast_pool_k8",
        "stream_ingest_k8", "stream_ingest_spec_k8"]
COUNTS = ("rounds", "uplink.payloads", "downlink.payloads", "ingest.payloads",
          "ingest.rejected")


def _ref_model():
    return ref_cnn.make_vgg("vgg_scenario", [8, 16, 32], 10, 3,
                            dense_width=16, pool_after=(0, 1, 2))


@pytest.fixture(scope="module")
def ref_training():
    """One recorded run of the reference's sync engine on the port's tiny
    setting (``sync_full_fedavg_fsfl``, 2 rounds): its initial state, each
    round's plan and client outputs.  Every sync scenario here trains the
    same way, so their runs take these outputs in place of training, on
    both sides."""
    s = ref_scenarios.get_scenario("sync_full_fedavg_fsfl")
    model, splits, ref_splits = _port_setting()
    eng = RefEngine(_ref_model(), ref_scenarios.build_protocol(s, ROUNDS),
                    ref_splits, jax.random.PRNGKey(42),
                    ref_scenarios.build_engine(s))
    server0 = jax.device_get(eng.server)
    pers0 = jax.device_get(jax.tree.map(lambda x: x[0],
                                        eng.local_train.persistent))
    outs, plan = [], []
    train0 = eng.local_train.train_cohort
    batches0 = ref_rounds.client_epoch_batches

    def train_cohort(key, idx, server, **kw):
        out = train0(key, idx, server, **kw)
        outs.append(jax.device_get(out))
        return out

    def client_epoch_batches(*a):
        b = batches0(*a)
        plan.append((np.arange(8), np.asarray(b)))
        return b

    eng.local_train.train_cohort = train_cohort
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_rounds, "client_epoch_batches", client_epoch_batches)
        eng.run(ROUNDS)
    return types.SimpleNamespace(model=model, splits=splits,
                                 ref_splits=ref_splits, server0=server0,
                                 pers0=pers0, plan=plan, outs=outs)


def _ref_forced(run, name: str, telemetry: str = "metrics"):
    """The reference's engine for scenario ``name`` with the recorded
    client outputs in place of its training."""
    s = dataclasses.replace(ref_scenarios.get_scenario(name),
                            telemetry=telemetry)
    eng = RefEngine(_ref_model(), ref_scenarios.build_protocol(s, ROUNDS),
                    run.ref_splits, jax.random.PRNGKey(42),
                    ref_scenarios.build_engine(s))
    outs = iter(run.outs)

    def train_cohort(key, idx, server, **kw):
        out = next(outs)
        eng.local_train.persistent = out.persistent
        return jax.tree.map(jnp.asarray, out)

    eng.local_train.train_cohort = train_cohort
    return eng.run(ROUNDS)


def _port_forced(run, name: str, monkeypatch, telemetry: str = "metrics"):
    """The port's engine for scenario ``name`` with the recorded client
    outputs in place of its training."""
    trained = []

    def train_cohort(self, idx, batch_idx, server):
        out = run.outs[len(trained)]
        trained.append(list(idx))
        persistent = convert.client_persistent(out.persistent)
        self.state = persistent
        return round_output(out, persistent)

    monkeypatch.setattr(rounds.LocalTrain, "train_cohort", train_cohort)
    s = dataclasses.replace(scenarios.get_scenario(name), telemetry=telemetry)
    res = engine.FederatedEngine(
        run.model, scenarios.build_protocol(s, ROUNDS), run.splits,
        engine_cfg=scenarios.build_engine(s),
        init_state=convert.initial_state(run.server0, run.pers0),
        plan=run.plan, device="cpu").run(ROUNDS)
    monkeypatch.undo()
    assert trained == [list(range(8))] * ROUNDS
    return res


def _telemetry_matches(port_rec, ref_rec) -> None:
    """Names of every counter, gauge and histogram equal; the event counts
    and the pool's task count equal; the byte counters each record's
    bytes."""
    p, r = port_rec.telemetry, ref_rec.telemetry
    for kind in ("counters", "counters_total", "gauges", "histograms"):
        assert set(p[kind]) == set(r[kind]), kind
    for key in COUNTS:
        assert p["counters"].get(key) == r["counters"].get(key), key
    assert p["counters"]["uplink.bytes"] == port_rec.up_bytes
    assert p["counters"]["downlink.bytes"] == port_rec.down_bytes
    assert p["gauges"]["uplink.pool_tasks"] == r["gauges"]["uplink.pool_tasks"]
    for h, v in r["histograms"].items():
        assert p["histograms"][h]["count"] == v["count"]


@pytest.mark.parametrize("name", SYNC)
def test_sync_scenario_teacher_forced_matches_reference(ref_training, name,
                                                        monkeypatch):
    """Up bytes equal; the server after the run: params and scales bitwise
    the reference's under streaming ingest (the same float64 fold and the
    same FedAvg step), within 2 ulps under the pooled gather (its float32
    mean sums in another order), the v1 BN mean within 2 ulps in both;
    telemetry as the reference's."""
    ref_res = _ref_forced(ref_training, name)
    res = _port_forced(ref_training, name, monkeypatch)
    for r, p in zip(ref_res.records, res.records):
        assert p.up_bytes == r.up_bytes
        assert p.participants == r.participants
        _telemetry_matches(p, r)
    want = jax.device_get(ref_res.server)
    if name.startswith("stream"):
        _bitwise(res.server.params, want.params)
        _bitwise(res.server.scales, want.scales)
    else:
        assert _ulps(res.server.params, want.params) <= 2.0
        assert _ulps(res.server.scales, want.scales) <= 2.0
    assert _ulps(res.server.bn_state, want.bn_state) <= 2.0


def test_bidirectional_telemetry_matches_reference(ref_training,
                                                   monkeypatch):
    """The downlink's counters (``downlink.payloads``, its sections) on
    ``bidi_sync_full``, teacher-forced as above."""
    ref_res = _ref_forced(ref_training, "bidi_sync_full")
    res = _port_forced(ref_training, "bidi_sync_full", monkeypatch)
    for r, p in zip(ref_res.records, res.records):
        assert p.down_bytes > 0
        _telemetry_matches(p, r)


def test_async_streaming_schedule_matches_reference():
    """``stream_ingest_async_b4`` along the reference's draws: the schedule
    exactly the reference's, the bytes within 2%, the telemetry names and
    counts the reference's (the ``async.batch_size`` histogram too)."""
    name = "stream_ingest_async_b4"
    ref_s, port_s = (dataclasses.replace(m.get_scenario(name),
                                         telemetry="metrics")
                     for m in (ref_scenarios, scenarios))
    (cfg, ref, port, ref_recs, ref_servers, port_recs, port_servers,
     _, _, n_test, _) = async_runs(ref_s, port_s)
    assert port.scheduler.batch_sizes == ref.scheduler.batch_sizes
    assert port.scheduler.now == ref.scheduler.now
    assert port.version == ref.version
    for r, p in zip(ref_recs, port_recs):
        assert p.participants == r.participants
        assert p.sim_time_s == r.sim_time_s
        assert abs(p.up_bytes - r.up_bytes) <= 0.02 * r.up_bytes
        assert "async.batch_size" in p.telemetry["histograms"]
        _telemetry_matches(p, r)


# ---------------------------------------------------------------- port only

def _spy_intake(monkeypatch, log):
    intake0 = rounds.Uplink.intake

    def intake(self, out, clients):
        contribs = intake0(self, out, clients)
        log.append(contribs)
        return contribs

    monkeypatch.setattr(rounds.Uplink, "intake", intake)


# a device coder in a thread pool: each thread encodes its own messages
_UNREGISTERED = {"int8_thread_pool": scenarios.Scenario(
    "int8_thread_pool", codec="int8-blockscale", uplink_workers=2)}


POOLED = [
    ("uplink_pool_k8", scenarios.Scenario("fp16_serial", codec="fp16")),
    ("cabac_fast_batch_k8", scenarios.get_scenario("sync_full_fedavg_fsfl")),
    ("cabac_fast_pool_k8", scenarios.get_scenario("sync_full_fedavg_fsfl")),
    ("int8_thread_pool", scenarios.Scenario("int8_serial",
                                            codec="int8-blockscale"))]


@pytest.mark.parametrize("name,serial", POOLED)
def test_pooled_payloads_byte_identical_to_serial(name, serial, monkeypatch):
    _pooled_against_serial(name, serial, monkeypatch, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("name,serial", POOLED)
def test_cuda_pooled_payloads_byte_identical_to_serial(name, serial,
                                                       monkeypatch):
    """The same on the card: the process workers code the numpy rows of
    the one-copy fetch; the int8 threads each launch their messages'
    encodes, every launch counted (one a message in both runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU "
                    "mode)")
    from repro_torch.kernels import delta_compress as dc
    launches = _pooled_against_serial(name, serial, monkeypatch, "cuda",
                                      dc)
    if "int8" in name:
        assert launches == [ROUNDS * 8, ROUNDS * 8]


def _pooled_against_serial(name, serial, monkeypatch, device, dc=None):
    """Run the pooled scenario and its serial twin on ``device``; hold
    every contribution and the server bitwise.  With the kernel module
    ``dc``, returns each run's int8 message launches (the port only: no
    reference data is made)."""
    model, splits = scenarios.default_setting(8, n_samples=N_SAMPLES)
    pool_s = _UNREGISTERED.get(name) or scenarios.get_scenario(name)
    logs, launches = {}, []
    for s in (pool_s, serial):
        logs[s.name] = []
        _spy_intake(monkeypatch, logs[s.name])
        if dc is not None:
            dc.reset_counters()
        eng = engine.FederatedEngine(
            model, scenarios.build_protocol(s, ROUNDS), splits,
            engine_cfg=scenarios.build_engine(s), device=device)
        res = eng.run(ROUNDS)
        monkeypatch.undo()
        if dc is not None:
            assert dc.LAUNCHES["delta_compress"] == dc.CALLS["delta_compress"]
            launches.append(dc.LAUNCHES["delta_compress"])
        logs[s.name] = (logs[s.name], res, eng.uplink.pool_tasks)
    (pooled, res_p, tasks), (serial_c, res_s, serial_tasks) = (
        logs[name], logs[serial.name])
    assert tasks == ROUNDS * (pool_s.uplink_workers if pool_s.uplink_batch
                              else 8)
    assert serial_tasks == 0
    assert [r.up_bytes for r in res_p.records] == [r.up_bytes
                                                   for r in res_s.records]
    for a_round, b_round in zip(pooled, serial_c):
        assert [c.payload_bytes for c in a_round] == [
            c.payload_bytes for c in b_round]
        for a, b in zip(a_round, b_round):
            _bitwise(a.delta_params, b.delta_params)
            _bitwise(a.delta_scales, b.delta_scales)
    for part in ("params", "scales", "bn_state"):
        _bitwise(getattr(res_p.server, part), getattr(res_s.server, part))
    return launches


def test_async_streaming_server_bitwise_gather():
    model, splits, _ = _port_setting()
    servers = {}
    for name in ("stream_ingest_async_b4", "async_b4_fsfl"):
        res = scenarios.run_scenario(name, rounds=3, model=model,
                                     splits=splits, device="cpu")
        servers[name] = (res.server, [r.up_bytes for r in res.records])
    (a, a_bytes), (b, b_bytes) = servers.values()
    assert a_bytes == b_bytes
    for part in ("params", "scales", "bn_state"):
        _bitwise(getattr(a, part), getattr(b, part))


def test_streaming_round_quarantines_a_corrupt_payload(monkeypatch):
    model, splits, _ = _port_setting()
    s = scenarios.get_scenario("stream_ingest_k8")
    encode0 = comms.get_codec("nnc-cabac").encode_batch

    def encode_batch(self, upds, spec, *, clients=None):
        out = encode0(upds, spec, clients=clients)
        bad = bytearray(out[3])
        bad[:16] = b"\xff" * 16
        return out[:3] + [bytes(bad)] + out[4:]

    eng = engine.FederatedEngine(model, scenarios.build_protocol(s, 1),
                                 splits, engine_cfg=scenarios.build_engine(s),
                                 device="cpu")
    carried = []
    reinject0 = rounds.LocalTrain.reinject_residual

    def reinject(self, client, delta):
        carried.append((client, {p: v.clone() for p, v in
                                  sorted_items(delta)}))
        return reinject0(self, client, delta)

    monkeypatch.setattr(type(comms.get_codec("nnc-cabac")), "encode_batch",
                        encode_batch)
    monkeypatch.setattr(rounds.LocalTrain, "reinject_residual", reinject)
    rec = eng.run(1).records[0]
    assert rec.participants == (0, 1, 2, 4, 5, 6, 7)
    assert [c for c, _ in carried] == [3]
    assert all(isinstance(v, torch.Tensor) for v in carried[0][1].values())
    assert rec.up_bytes > 0 and np.isfinite(rec.test_acc)


# ---------------------------------------------------------------- telemetry

def test_telemetry_off_records_nothing():
    off = obs.make_telemetry("off")
    assert off is obs.make_telemetry("off")
    assert off.recorder is obs.NOOP and off.metrics is obs.NOOP_METRICS
    assert obs.trace.span("x", k=1) is obs.trace.span("y")
    model, splits, _ = _port_setting()
    res = scenarios.run_scenario("stream_ingest_k8", rounds=1, model=model,
                                 splits=splits, device="cpu")
    assert res.records[0].telemetry is None
    assert len(res.telemetry.recorder) == 0
    assert res.telemetry.round_snapshot(1) is None


def test_spans_show_in_a_torch_profile():
    """The port's one span: with telemetry off it still marks a
    ``record_function`` interval while a ``torch.profiler`` session
    records (what ``chip_smoke.py``'s profiled round reads), and records
    into a ``"trace"`` recorder too."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.trace.span("uplink.intake", n=1):
            torch.ones(4).sum()
    assert "uplink.intake" in {e.key for e in prof.key_averages()}
    tel = obs.make_telemetry("trace")
    with tel.activate():
        with obs.trace.span("uplink.intake", n=1):
            pass
    assert [s.name for s in tel.recorder.snapshot()] == ["uplink.intake"]


def test_trace_exports(tmp_path):
    """A ``"trace"`` run's spans export as JSONL and as Chrome trace-event
    JSON (complete events with pid and tid, per-round byte counters)."""
    import json
    model, splits, _ = _port_setting()
    s = dataclasses.replace(scenarios.get_scenario("stream_ingest_k8"),
                            telemetry="trace")
    res = scenarios.run_scenario(s, rounds=1, model=model, splits=splits,
                                 device="cpu")
    tel = res.telemetry
    names = {sp.name for sp in tel.recorder.snapshot()}
    assert {"round", "uplink.intake", "ingest.decode", "ingest.fold",
            "server_step", "evaluate"} <= names
    n = tel.export_jsonl(str(tmp_path / "run.jsonl"))
    assert n == len((tmp_path / "run.jsonl").read_text().splitlines()) > 0
    tel.export_chrome_trace(str(tmp_path / "run.trace.json"))
    events = json.loads((tmp_path / "run.trace.json").read_text())[
        "traceEvents"]
    assert all({"pid", "tid", "ts"} <= set(e) for e in events)
    assert any(e["ph"] == "C" and e["name"] == "uplink.bytes"
               for e in events)
