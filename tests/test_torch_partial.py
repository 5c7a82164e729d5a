"""Partial updates (the paper's third setting) against the reference.

* A client round with ``trainable_predicate=_fc_only`` from the same state,
  data and batch order as the reference's ``client_round``, held to the
  bounds of ``tests/test_torch_protocol.py`` (one quantization step per
  element, at most 1% of the levels moved; loss and BN statistics to rtol
  1e-4; equal validation accuracies; scales within one fine step at no
  more than 3% of their levels).  Outside the classifier the deltas, the
  levels and the new residual are exact zeros on both sides: Adam moves a
  leaf whose gradient is zero by exactly 0.
* ``partial_fc_k4`` for 2 rounds on the tiny scenario VGG (1,280 samples
  of the port's synthetic set given to both, 3 local steps), from the
  reference engine's initial state along its cohorts and batch orders,
  held to
  the bounds of ``tests/test_torch_slice.py``; on both sides every server
  params leaf outside ``fc*`` stays bitwise at its initial value, and the
  payloads carry the classifier only.
* The five scenarios of this slice are registered with the reference's
  field values (but the executor: the port's is the serial one).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as ref_protocol
from repro.data.federated import FederatedSplits as RefSplits
from repro.data.federated import client_epoch_batches
from repro.fl import scenarios as ref_scenarios
from repro.fl.engine import FederatedEngine as RefEngine
from repro.fl.sampling import SamplingConfig, sample_cohort
from repro.models import cnn as ref_cnn
from repro_torch import convert
from repro_torch.core import protocol
from repro_torch.fl import engine, scenarios
from repro_torch.kernels import level_assign as la
from repro_torch.models import cnn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STEP = 4.88e-4
FINE = 2.38e-6


def _fc(path):
    return path.startswith("fc")


def _flat(tree):
    return {f"{m}/{n}": np.asarray(v) for m, d in tree.items()
            for n, v in d.items()}


def _flat_port(tree):
    return {f"{m}/{n}": v.detach().numpy() for m, d in tree.items()
            for n, v in d.items()}


def _model(m):
    return m.make_vgg("t", [8, 16, 32], 10, 3, dense_width=16,
                      pool_after=(0, 1, 2))


def _cfg(m):
    cfg = m.baseline_configs(
        fixed_sparsity=0.9, batch_size=16, local_lr=2e-3, scale_lr=2e-2,
        scale_subepochs=2, scale_schedule="linear", total_rounds=2)["fsfl"]
    return dataclasses.replace(cfg, trainable_predicate=scenarios._fc_only)


@functools.lru_cache(maxsize=1)
def _ref_protocol():
    """The reference's init and jitted client round, compiled once."""
    init, ref_round, _ = ref_protocol.make_protocol(
        _model(ref_cnn), _cfg(ref_protocol), 3)
    return init, jax.jit(ref_round)


@pytest.mark.parametrize("seed", [0, 1])
def test_partial_client_round_within_tolerance(seed):
    init, ref_round = _ref_protocol()
    server, pers = init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    # a residual on the classifier only: frozen leaves never carry one
    pers = pers._replace(residual={
        m: {n: jnp.asarray((2e-4 * rng.standard_normal(r.shape)
                            * _fc(m)).astype(np.float32))
            for n, r in d.items()} for m, d in pers.residual.items()})
    x = rng.standard_normal((64, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)
    vx = rng.standard_normal((24, 32, 32, 3)).astype(np.float32)
    vy = rng.integers(0, 10, 24).astype(np.int32)
    bidx = rng.permutation(64)[:48].reshape(3, 16)
    ref = jax.device_get(ref_round(
        server, pers, jnp.asarray(x), jnp.asarray(y), jnp.asarray(vx),
        jnp.asarray(vy), jnp.asarray(bidx)))

    _, port_round, _ = protocol.make_protocol(_model(cnn), _cfg(protocol), 3)
    with torch.no_grad():
        out = port_round(
            convert.server_state(jax.device_get(server)),
            convert.client_persistent(jax.device_get(pers)),
            torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
            torch.from_numpy(vx), torch.from_numpy(vy.astype(np.int64)),
            torch.from_numpy(bidx))

    np.testing.assert_allclose(float(out.metrics["train_loss"]),
                               float(ref.metrics["train_loss"]), rtol=1e-4)
    for k, v in _flat(ref.bn_state).items():
        np.testing.assert_allclose(_flat_port(out.bn_state)[k], v,
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    ref_rec, port_rec = _flat(ref.recon_delta_params), _flat_port(
        out.recon_delta_params)
    ref_lv, port_lv = _flat(ref.levels_params), _flat_port(out.levels_params)
    ref_res, port_res = (_flat(ref.persistent.residual),
                         _flat_port(out.persistent.residual))
    moved = total = 0
    for k in ref_rec:
        if not _fc(k):   # frozen: exact zeros on both sides
            for tree in (ref_rec, port_rec, ref_lv, port_lv, ref_res,
                         port_res):
                assert not tree[k].any(), k
            continue
        np.testing.assert_allclose(port_rec[k], ref_rec[k], rtol=0,
                                   atol=STEP * 1.01, err_msg=k)
        np.testing.assert_allclose(port_res[k], ref_res[k], rtol=0,
                                   atol=STEP * 1.01, err_msg=k)
        moved += int(np.sum(port_lv[k] != ref_lv[k]))
        total += ref_lv[k].size
    assert total and moved <= 0.01 * total, (moved, total)
    assert any(port_lv[k].any() for k in port_lv if _fc(k))
    for m in ("val_acc_unscaled", "val_acc"):
        assert float(out.metrics[m]) == float(ref.metrics[m]), m
    ref_slv, port_slv = _flat(ref.levels_scales), _flat_port(
        out.levels_scales)
    ref_srec, port_srec = (_flat(ref.recon_delta_scales),
                           _flat_port(out.recon_delta_scales))
    moved = total = 0
    for k in ref_slv:
        np.testing.assert_allclose(port_srec[k], ref_srec[k], rtol=0,
                                   atol=FINE * 1.01, err_msg=k)
        moved += int(np.sum(port_slv[k] != ref_slv[k]))
        total += ref_slv[k].size
    assert moved <= 0.03 * total, (moved, total)


ROUNDS = 2
N_SAMPLES = 1280
MAX_FLIPS = 5
MAX_OFF = 34         # 0.5% of the 6,786 params


def test_partial_fc_k4_two_rounds_match_reference():
    name = "partial_fc_k4"
    s = ref_scenarios.get_scenario(name)
    cfg = ref_scenarios.build_protocol(s, ROUNDS)
    # the port's tiny setting, its arrays also the reference's
    port_model, port_splits = scenarios.default_setting(
        s.num_clients, n_samples=N_SAMPLES)
    splits = RefSplits(*(
        jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
        for a in (getattr(port_splits, f).numpy() for f in (
            "client_x", "client_y", "client_val_x", "client_val_y",
            "test_x", "test_y"))))
    model = _model(ref_cnn)
    n_train = splits.client_x.shape[1]
    steps = max(1, n_train // cfg.batch_size)
    assert steps == 3
    key = jax.random.PRNGKey(42)
    _, key = jax.random.split(key)      # k_init: the engine's init
    plan = []
    for _ in range(ROUNDS):
        key, kb = jax.random.split(key)
        key, ks = jax.random.split(key)
        idx = sample_cohort(ks, s.num_clients,
                            SamplingConfig(cohort_size=s.cohort_size))
        plan.append((idx, np.asarray(client_epoch_batches(
            kb, len(idx), n_train, cfg.batch_size))))

    ref = RefEngine(model, cfg, splits, jax.random.PRNGKey(42),
                    ref_scenarios.build_engine(s))
    # its initial state (drawn from k_init; every client's the same)
    server0 = jax.device_get(ref.server)
    pers0 = jax.device_get(jax.tree.map(lambda x: x[0],
                                        ref.local_train.persistent))
    ref_recs, ref_servers = [], []
    for _ in range(ROUNDS):
        ref_recs += ref.run(1).records
        ref_servers.append(jax.device_get(ref.server))

    port_s = scenarios.get_scenario(name)
    port = engine.FederatedEngine(
        port_model, scenarios.build_protocol(port_s, ROUNDS), port_splits,
        engine_cfg=scenarios.build_engine(port_s),
        init_state=convert.initial_state(server0, pers0), plan=plan,
        device="cpu")
    assert sorted(port.uplink.spec.sent_paths) == [
        "fc0/b", "fc0/w", "fc1/b", "fc1/w"]
    la.reset_counters()
    port_recs, port_servers = [], []
    for _ in range(ROUNDS):
        port_recs += port.run(1).records
        port_servers.append(port.server)
    assert la.CALLS["level_assign"] == 4 * ROUNDS * len(
        _flat(server0.params))   # one call a leaf, frozen leaves too

    n_test = len(splits.test_y)
    for (idx, _), r, p in zip(plan, ref_recs, port_recs):
        assert r.participants == p.participants == tuple(int(i) for i in idx)
        assert abs(p.test_acc - r.test_acc) <= 1 / n_test + 1e-6
        # the payloads carry the classifier's levels and every scale
        assert abs(p.up_bytes - r.up_bytes) <= 0.02 * r.up_bytes

    params0 = _flat(server0.params)
    for rnd, (ref_srv, port_srv) in enumerate(zip(ref_servers, port_servers),
                                              1):
        ref_p, port_p = _flat(ref_srv.params), _flat_port(port_srv.params)
        for k, v0 in params0.items():
            if not _fc(k):
                assert np.array_equal(ref_p[k].view(np.int32),
                                      v0.view(np.int32)), (rnd, k)
                assert np.array_equal(port_p[k].view(np.int32),
                                      v0.view(np.int32)), (rnd, k)
        assert any(not np.array_equal(port_p[k], params0[k])
                   for k in params0 if _fc(k))
        diff = np.concatenate([np.abs(port_p[k] - v).ravel()
                               for k, v in ref_p.items()])
        flips = int(np.sum(diff > cfg.step_size * 1.01))
        off = int(np.sum(diff > 1e-6))
        assert flips <= MAX_FLIPS and off <= MAX_OFF, (rnd, flips, off)
        ref_sc, port_sc = _flat(ref_srv.scales), _flat_port(port_srv.scales)
        for k, v in ref_sc.items():
            np.testing.assert_allclose(port_sc[k], v, rtol=0,
                                       atol=rnd * cfg.fine_step_size * 1.01,
                                       err_msg=f"round {rnd} scales {k}")


NEW = ["partial_fc_k4", "bnwire_v2_full", "chan_slow_cabac", "chan_slow_raw",
       "chan_lossy_k4"]


@pytest.mark.parametrize("name", NEW)
def test_scenarios_registered_as_in_the_reference(name):
    port, ref = scenarios.get_scenario(name), ref_scenarios.get_scenario(name)
    # the reference's default executor is "vmap"; the port's, as in every
    # scenario it registers, the serial one (the batched one is queued)
    assert (port.executor, ref.executor) == ("serial", "vmap")
    for f in dataclasses.fields(port):
        if f.name == "executor":
            continue
        want = getattr(ref, f.name)
        got = getattr(port, f.name)
        if f.name == "channel" and want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    port_cfg = scenarios.build_protocol(port, 2)
    ref_cfg = ref_scenarios.build_protocol(ref, 2)
    assert (port_cfg.trainable_predicate is None) == (
        ref_cfg.trainable_predicate is None)
    port_eng, ref_eng = scenarios.build_engine(port), \
        ref_scenarios.build_engine(ref)
    for f in ("wire_schema", "codec", "device_encode", "bidirectional"):
        assert getattr(port_eng, f) == getattr(ref_eng, f), f
    assert (port_eng.up_predicate is None) == (ref_eng.up_predicate is None)
    for path in ("fc0/w", "fc1/b", "conv0/w", "bn2/gamma"):
        for fn in (port_cfg.trainable_predicate, port_eng.up_predicate):
            if fn is not None:
                assert fn(path, None) == _fc(path)


def test_register_names_the_scenario_in_its_errors():
    bad = scenarios.Scenario("bad_channel", channel=scenarios.ChannelConfig(),
                             wire_schema=3)
    with pytest.raises(ValueError, match="scenario 'bad_channel': unknown "
                                         "wire schema"):
        scenarios.register(bad)
    with pytest.raises(ValueError, match="scenario 'bad_protocol': unknown "
                                         "protocol"):
        scenarios.register(scenarios.Scenario("bad_protocol",
                                              protocol="nope"))
    assert "bad_channel" not in scenarios.SCENARIOS
