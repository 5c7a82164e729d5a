"""Weighted sampling, the dirichlet partition, the new scenarios'
registrations, and whole sync runs of the new sampling and server
settings, against the reference.

* ``sample_cohort`` / ``sample_available`` with ``strategy="weighted"``:
  the reference's validation (one weight per client, in the sampler, in
  ``EngineConfig.validate`` and at scenario registration), sorted distinct
  draws inside the support (a zero weight is never drawn), and inclusion
  frequencies within 0.03 of the reference's over 4,000 draws each.
* ``dirichlet_partition``: the client index sets of the reference's
  ``split_federated(dirichlet_alpha=0.1)`` and ``(1.0)`` bit for bit, on
  the reference's permuted data with the reference's integer seed.
* The 14 scenarios of this slice are registered with the reference's
  parameters.
* Whole runs (``sync_weighted_k4`` and ``noniid_dir1_k4_fedyogi``, and in
  ``test_torch_server_opt.py`` the three FedOpt cohort scenarios): 2
  rounds on the tiny setting (1,280 samples, 3 local steps a client),
  both packages on the same arrays, from the reference's initial state
  along the reference's cohorts (weighted draws included) and batch
  orders.  The arrays are the port's own IID draw, or, for the dirichlet
  scenario, the reference's own ``default_setting`` split: on the port's
  dirichlet draw one client takes another discrete Eq. 4 decision in
  round 1 (its scales move in every layer), with FedAvg as with FedYogi,
  the seed sensitivity of ROADMAP.md section 3.  Participants equal; test accuracy within one test image;
  ``up_bytes`` within 2%; server params within one quantization step of
  the server optimizer's update except at most ``MAX_FLIPS`` elements,
  and at most ``MAX_OFF`` off by more than 1e-6; scales within r fine
  steps after round r (the tolerances of ``test_torch_partial.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import federated as ref_federated
from repro.data.federated import FederatedSplits as RefSplits
from repro.data.federated import client_epoch_batches
from repro.fl import sampling as ref_sampling
from repro.fl import scenarios as ref_scenarios
from repro.fl.engine import FederatedEngine as RefEngine
from repro.models import cnn as ref_cnn
from repro_torch import convert
from repro_torch.data import federated
from repro_torch.fl import engine, sampling, scenarios


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WEIGHTS = (1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 4.0, 4.0)


def _weighted(weights=WEIGHTS, k=4, m=sampling):
    return m.SamplingConfig(cohort_size=k, strategy="weighted",
                            weights=weights)


def test_weighted_sampling_validation():
    gen = torch.Generator().manual_seed(0)
    for bad in (None, WEIGHTS[:7]):
        cfg = _weighted(bad)
        with pytest.raises(ValueError, match="one weight per client"):
            sampling.sample_cohort(gen, 8, cfg)
        with pytest.raises(ValueError, match="one weight per client"):
            ref_sampling.sample_cohort(jax.random.PRNGKey(0), 8,
                                       _weighted(bad, m=ref_sampling))
        with pytest.raises(ValueError, match="one weight per client"):
            engine.EngineConfig(sampling=cfg).validate(8)
    with pytest.raises(ValueError, match="unknown sampling strategy"):
        sampling.sample_cohort(gen, 8, sampling.SamplingConfig(
            cohort_size=4, strategy="zipf"))
    with pytest.raises(ValueError, match="scenario 'bad_weights': weighted"):
        scenarios.register(scenarios.Scenario(
            "bad_weights", cohort_size=4, sampling_strategy="weighted",
            sampling_weights=WEIGHTS[:5]))
    assert "bad_weights" not in scenarios.SCENARIOS
    model, splits = scenarios.default_setting(4)
    with pytest.raises(ValueError, match="8 sampling weights but splits "
                                         "have 4 clients"):
        scenarios.run_scenario("sync_weighted_k4", rounds=1, model=model,
                               splits=splits, device="cpu")
    # full participation draws nothing; a short idle set is returned whole
    assert list(sampling.sample_cohort(gen, 8, _weighted(k=8))) == list(
        range(8))
    assert list(sampling.sample_available(
        gen, np.array([6, 2]), 3, _weighted())) == [2, 6]


DRAWS = 4000


def _port_inclusion(weights, k, draw):
    gen = torch.Generator().manual_seed(5)
    counts = np.zeros(len(weights))
    for _ in range(DRAWS):
        idx = draw(gen)
        assert len(set(idx.tolist())) == k
        assert list(idx) == sorted(idx)
        counts[idx] += 1
    return counts / DRAWS


def _ref_inclusion(weights, k, n):
    p = jnp.asarray(weights, jnp.float32)
    p = p / jnp.sum(p)
    keys = jax.random.split(jax.random.PRNGKey(9), DRAWS)
    idx = np.asarray(jax.vmap(lambda kk: jax.random.choice(
        kk, n, (k,), replace=False, p=p))(keys))
    return np.bincount(idx.ravel(), minlength=n) / DRAWS


@pytest.mark.parametrize("weights", [WEIGHTS,
                                     (0.0, 3.0, 1.0, 0.0, 2.0, 5.0, 1.0,
                                      0.5)])
def test_weighted_cohort_support_and_frequencies(weights):
    cfg = _weighted(weights)
    port = _port_inclusion(weights, 4, lambda g: sampling.sample_cohort(
        g, 8, cfg))
    ref = _ref_inclusion(weights, 4, 8)
    zero = np.asarray(weights) == 0
    assert not port[zero].any() and not ref[zero].any()
    np.testing.assert_allclose(port, ref, atol=0.03)


def test_weighted_sample_available_frequencies():
    available = np.array([1, 2, 4, 5, 7])
    cfg = _weighted()
    port = _port_inclusion(WEIGHTS, 2, lambda g: sampling.sample_available(
        g, available, 2, cfg))
    ref = _ref_inclusion([WEIGHTS[c] for c in available], 2,
                         len(available))
    assert not port[[0, 3, 6]].any()
    np.testing.assert_allclose(port[available], ref, atol=0.03)


@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_dirichlet_partition_bitwise_equal_to_reference(alpha):
    """The reference's ``split_federated`` on its own synthetic data, and
    the port's partition of the same permuted labels with the integer
    seed the reference draws from the same key."""
    _, splits = ref_scenarios.default_setting(8)
    x = jnp.concatenate([splits.test_x, splits.client_val_x.reshape(
        (-1,) + splits.test_x.shape[1:]), splits.client_x.reshape(
            (-1,) + splits.test_x.shape[1:])])
    y = jnp.concatenate([splits.test_y, splits.client_val_y.ravel(),
                         splits.client_y.ravel()])
    key = jax.random.PRNGKey(3)
    ref = ref_federated.split_federated(key, x, y, 8, dirichlet_alpha=alpha)
    perm = jax.random.permutation(key, x.shape[0])
    n_test = int(x.shape[0] * (1.0 - 0.7 - 0.15))
    rest_x = np.asarray(x[perm])[n_test:]
    rest_y = np.asarray(y[perm])[n_test:]
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    sel = federated.dirichlet_partition(rest_y, 8, alpha, seed)
    per = len(rest_y) // 8
    assert sel.shape == (8 * per,) and len(set(sel.tolist())) == len(sel)
    cx = rest_x[sel].reshape((8, per) + rest_x.shape[1:])
    cy = rest_y[sel].reshape(8, per)
    n_val = ref.client_val_y.shape[1]
    for got, want in ((cy[:, n_val:], ref.client_y),
                      (cy[:, :n_val], ref.client_val_y),
                      (cx[:, n_val:], ref.client_x),
                      (cx[:, :n_val], ref.client_val_x)):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # the labels are skewed as the alpha asks (IID shares would be ~0.1)
    share = max(np.bincount(c, minlength=10).max() / per for c in cy)
    assert share > (0.5 if alpha == 0.1 else 0.2)


def test_port_dirichlet_split_draws_its_seed_from_the_generator():
    gen = torch.Generator().manual_seed(11)
    x = torch.arange(200 * 3, dtype=torch.float32).reshape(200, 3)
    y = torch.arange(200) % 10
    got = federated.split_federated(torch.Generator().manual_seed(11), x, y,
                                    4, dirichlet_alpha=0.1)
    perm = torch.randperm(200, generator=gen)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
    rest = perm[int(200 * (1.0 - 0.7 - 0.15)):]
    sel = federated.dirichlet_partition(y[rest].numpy(), 4, 0.1, seed)
    want = y[rest][torch.as_tensor(sel)].reshape(4, -1)
    n_val = got.client_val_y.shape[1]
    assert torch.equal(got.client_y, want[:, n_val:])
    assert torch.equal(got.client_val_y, want[:, :n_val])
    assert torch.equal(got.client_x[..., 0], 3.0 * x[rest][
        torch.as_tensor(sel)].reshape(4, -1, 3)[:, n_val:, 0] / 3.0)


NEW = ["sync_full_fedavg_raw", "exec_serial_k4", "sync_k4_fedadam",
       "sync_k4_fedavgm", "sync_weighted_k4", "sync_k4_fedadagrad",
       "noniid_dir01_fsfl", "noniid_dir1_k4_fedyogi", "noniid_dir01_golomb",
       "noniid_dir01_fp16", "async_b4_fsfl", "async_b2_m4_fedadam",
       "bnwire_v2_async", "async_windowed_b4"]


@pytest.mark.parametrize("name", NEW)
def test_scenarios_registered_as_in_the_reference(name):
    port, ref = scenarios.get_scenario(name), ref_scenarios.get_scenario(name)
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "description":
            continue      # prose; the port's names its own executor
        assert got == want, f.name
    p_eng, r_eng = scenarios.build_engine(port), ref_scenarios.build_engine(
        ref)
    for f in ("mode", "codec", "wire_schema", "bidirectional"):
        assert getattr(p_eng, f) == getattr(r_eng, f), f
    for part in ("sampling", "server_opt"):
        assert dataclasses.asdict(getattr(p_eng, part)) == (
            dataclasses.asdict(getattr(r_eng, part))), part
    for f in dataclasses.fields(p_eng.async_cfg):
        assert getattr(p_eng.async_cfg, f.name) == getattr(
            r_eng.async_cfg, f.name), f.name
    assert dataclasses.asdict(scenarios.build_protocol(port, 2)) == \
        dataclasses.asdict(ref_scenarios.build_protocol(ref, 2))


@pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
def test_every_registered_scenario_runs_on_the_cpu(name):
    res = scenarios.run_scenario(name, rounds=2, device="cpu")
    assert len(res.records) == 2
    assert all(r.up_bytes > 0 and r.participants for r in res.records)


def _records(res):
    return [(r.up_bytes, r.test_acc, r.train_loss, r.participants)
            for r in res.records]


@pytest.fixture(scope="module")
def mesh_twin_records():
    """The cohort scenarios' setting through the default executor: one
    block on the CPU's mesh is the batched round itself."""
    s = dataclasses.replace(scenarios.get_scenario("sharded_cohort_full"),
                            executor="vmap")
    return _records(scenarios.run_scenario(s, rounds=2, device="cpu"))


@pytest.mark.parametrize("name", ["dist_cohort_full", "sharded_cohort_full"])
def test_unported_scenarios_name_their_queue_item(name, mesh_twin_records):
    """Kept under its first name: the last scenario not ported,
    ``dist_cohort_full``, runs now (one process: the local mesh), with
    the records of ``sharded_cohort_full`` and of their batched twin."""
    assert name in ref_scenarios.SCENARIOS
    res = scenarios.run_scenario(name, rounds=2, device="cpu")
    assert _records(res) == mesh_twin_records
    assert len(scenarios.SCENARIOS) == len(ref_scenarios.SCENARIOS) == 35


# ------------------------------------------------------------ whole runs

ROUNDS = 2
N_SAMPLES = 1280
MAX_FLIPS = 5
MAX_OFF = 34         # 0.5% of the 6,786 params


def _flat(tree, to_np=np.asarray):
    return {f"{m}/{n}": to_np(v) for m, d in tree.items() for n, v in d.items()}


def sync_runs(name: str, rounds: int = ROUNDS, ref_data: bool = False):
    """The reference and the port on one tiny setting (the port's arrays,
    or with ``ref_data`` the reference's) from the reference's initial
    state along the reference's cohorts and batch orders (its key
    discipline replayed: ``key, kb = split(key)``, then, when sampling,
    ``key, ks = split(key)``).  Returns (cfg, plan, records and servers of
    each, test-set size)."""
    s = ref_scenarios.get_scenario(name)
    cfg = ref_scenarios.build_protocol(s, rounds)
    port_model, port_splits = scenarios.default_setting(
        s.num_clients, n_samples=N_SAMPLES)
    if ref_data:
        _, rs = ref_scenarios.default_setting(
            s.num_clients, n_samples=N_SAMPLES,
            dirichlet_alpha=s.dirichlet_alpha)
        port_splits = federated.FederatedSplits.from_numpy(*jax.device_get((
            rs.client_x, rs.client_y, rs.client_val_x, rs.client_val_y,
            rs.test_x, rs.test_y)))
    else:
        assert s.dirichlet_alpha is None
    splits = RefSplits(*(
        jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
        for a in (getattr(port_splits, f).numpy() for f in (
            "client_x", "client_y", "client_val_x", "client_val_y",
            "test_x", "test_y"))))
    n_train = splits.client_x.shape[1]
    assert max(1, n_train // cfg.batch_size) == 3
    ref_eng_cfg = ref_scenarios.build_engine(s)
    key = jax.random.PRNGKey(42)
    _, key = jax.random.split(key)      # k_init: the engine's init
    plan = []
    for _ in range(rounds):
        key, kb = jax.random.split(key)
        if ref_eng_cfg.sampling.is_full(s.num_clients):
            idx = np.arange(s.num_clients)
        else:
            key, ks = jax.random.split(key)
            idx = ref_sampling.sample_cohort(ks, s.num_clients,
                                             ref_eng_cfg.sampling)
        plan.append((idx, np.asarray(client_epoch_batches(
            kb, len(idx), n_train, cfg.batch_size))))
    ref = RefEngine(ref_cnn.make_vgg("vgg_scenario", [8, 16, 32], 10, 3,
                                     dense_width=16, pool_after=(0, 1, 2)),
                    cfg, splits, jax.random.PRNGKey(42), ref_eng_cfg)
    server0 = jax.device_get(ref.server)
    pers0 = jax.device_get(jax.tree.map(lambda x: x[0],
                                        ref.local_train.persistent))
    ref_recs, ref_servers = [], []
    for _ in range(rounds):
        ref_recs += ref.run(1).records
        ref_servers.append(jax.device_get(ref.server))
    port_s = scenarios.get_scenario(name)
    port = engine.FederatedEngine(
        port_model, scenarios.build_protocol(port_s, rounds), port_splits,
        engine_cfg=scenarios.build_engine(port_s),
        init_state=convert.initial_state(server0, pers0), plan=plan,
        device="cpu")
    port_recs, port_servers = [], []
    for _ in range(rounds):
        port_recs += port.run(1).records
        port_servers.append(convert.to_numpy(port.server))
    return cfg, plan, ref_recs, ref_servers, port_recs, port_servers, len(
        splits.test_y)


def check_whole_run(cfg, ref_recs, ref_servers, port_recs, port_servers,
                    n_test, gain: float = 1.0):
    """The whole-run tolerances; ``gain`` bounds how far the server
    optimizer moves its update per unit of mean delta (1 for FedAvg)."""
    for r, p in zip(ref_recs, port_recs):
        assert p.participants == r.participants
        assert abs(p.test_acc - r.test_acc) <= 1 / n_test + 1e-6
        assert abs(p.up_bytes - r.up_bytes) <= 0.02 * r.up_bytes
    for rnd, (ref_srv, port_srv) in enumerate(zip(ref_servers, port_servers),
                                              1):
        ref_p, port_p = _flat(ref_srv.params), _flat(port_srv.params)
        diff = np.concatenate([np.abs(port_p[k] - v).ravel()
                               for k, v in ref_p.items()])
        flips = int(np.sum(diff > gain * cfg.step_size * 1.01))
        off = int(np.sum(diff > 1e-6))
        print(f"round {rnd}: max |param diff| {diff.max():.3g}, {off} off "
              f"by > 1e-6, {flips} flips")
        assert flips <= MAX_FLIPS and off <= MAX_OFF, (rnd, flips, off)
        ref_sc, port_sc = _flat(ref_srv.scales), _flat(port_srv.scales)
        for k, v in ref_sc.items():
            np.testing.assert_allclose(port_sc[k], v, rtol=0,
                                       atol=rnd * cfg.fine_step_size * 1.01,
                                       err_msg=f"round {rnd} scales {k}")


@pytest.mark.parametrize("name", ["sync_weighted_k4",
                                  "noniid_dir1_k4_fedyogi"])
def test_sync_runs_match_reference(name):
    cfg, plan, ref_recs, ref_servers, port_recs, port_servers, n_test = \
        sync_runs(name, ref_data=name.startswith("noniid"))
    for (idx, _), r in zip(plan, ref_recs):
        assert r.participants == tuple(int(i) for i in idx)
    gain = 1.0 if name == "sync_weighted_k4" else 1e-2 / 1e-3
    check_whole_run(cfg, ref_recs, ref_servers, port_recs, port_servers,
                    n_test, gain)
