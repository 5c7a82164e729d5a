"""The FedOpt server optimizers against the reference.

* ``sgd`` with momentum, ``adam`` with FedOpt's parameters, ``yogi`` and
  ``adagrad`` (also with a learning-rate schedule, read at the step before
  the increment), six steps each on numpy-seeded trees, against
  ``repro.optim``; and ``make_server_opt`` for all five server names
  through ``server_update`` (the pseudo-gradient ``-delta``), the state
  carried across the steps.
* Tolerance: ``sgd`` (FedAvg, FedAvgM) is bitwise.  The adaptive
  optimizers follow the reference's operation order, and with a
  correctly rounded float32 square root (the reference's, and CUDA's
  ``sqrtf``) they are bitwise too; with torch's own CPU ``sqrt``, which
  can be one ulp off the correctly rounded root, every element is within
  2 ulps of the reference (one from the root, one more from the division
  by it).
* Under bidirectional compression the downlink compresses the server
  optimizer's update, not the mean delta.
* Whole runs of ``sync_k4_fedadam``, ``sync_k4_fedavgm`` and
  ``sync_k4_fedadagrad``: 2 rounds with the reference's plan, held to the
  whole-run tolerances of ``test_torch_sampling.py`` (whose helpers run
  them), the params' quantization step scaled by the server optimizer's
  largest gain (``lr / eps`` for the adaptive ones).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.fl import server_opt as ref_server_opt
from repro.optim import schedule as ref_schedule
from repro_torch import convert, optim
from repro_torch.fl import engine, scenarios, server_opt
from repro_torch.optim import schedule
from repro_torch.tree import sorted_items
from test_torch_sampling import check_whole_run, sync_runs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = {"conv0": {"w": (8, 3, 3, 3), "b": (8,)},
          "fc0": {"w": (10, 16), "b": (10,)}}
STEPS = 6


def _trees(seed: int, n: int, scale: float):
    rng = np.random.default_rng(seed)
    return [{m: {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in d.items()} for m, d in SHAPES.items()}
            for _ in range(n)]


_SQRT = torch.sqrt


def _exact_sqrt(x):
    """The correctly rounded float32 root (double rounding is exact for
    sqrt from float64)."""
    return _SQRT(x.double()).to(x.dtype)


def _ulps(ref_tree, port_tree) -> int:
    """Largest distance in units in the last place over the leaves."""
    want = dict(sorted_items(jax.device_get(ref_tree)))
    worst = 0
    for path, v in sorted_items(port_tree):
        a = np.asarray(want[path]).view(np.int32).astype(np.int64)
        b = v.numpy().view(np.int32).astype(np.int64)
        worst = max(worst, int(np.abs(a - b).max()))
    return worst


def _run(ref_opt, port_opt, grads, params=None) -> list[int]:
    """Steps both optimizers along ``grads``; ulps per step (updates and
    every state leaf)."""
    p0 = grads[0] if params is None else params
    r_state = ref_opt.init(jax.tree.map(jnp.asarray, p0))
    p_state = port_opt.init(convert.to_tensors(p0))
    out = []
    for g in grads:
        r_upd, r_state = ref_opt.update(jax.tree.map(jnp.asarray, g), r_state)
        p_upd, p_state = port_opt.update(convert.to_tensors(g), p_state)
        worst = _ulps(r_upd, p_upd)
        for field in p_state._fields:
            r, p = getattr(r_state, field), getattr(p_state, field)
            if field == "step":
                assert int(p) == int(r)
            elif p is not None:
                worst = max(worst, _ulps(r, p))
        out.append(worst)
    return out


# each built from (optimizers, schedules) of one package; bitwise with
# torch's own sqrt or not
OPTIMIZERS = {
    "sgd_momentum": (lambda o, s: o.sgd(0.5, momentum=0.9), True),
    "adam_fedopt": (lambda o, s: o.adam(1e-2, b1=0.9, b2=0.99, eps=1e-3),
                    False),
    "yogi": (lambda o, s: o.yogi(1e-2, b1=0.9, b2=0.99, eps=1e-3), False),
    "adagrad": (lambda o, s: o.adagrad(1e-2, eps=1e-3), False),
    "yogi_linear": (lambda o, s: o.yogi(s.linear(2e-2, STEPS)), False),
    "adagrad_linear": (lambda o, s: o.adagrad(s.linear(2e-2, STEPS)),
                       False),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_reference(name, monkeypatch):
    make, exact_everywhere = OPTIMIZERS[name]
    grads = _trees(1, STEPS, 1e-2)

    def run():
        return _run(make(ref_optim, ref_schedule), make(optim, schedule),
                    grads)

    ulps = run()
    assert max(ulps) <= (0 if exact_everywhere else 2), ulps
    monkeypatch.setattr(torch, "sqrt", _exact_sqrt)
    assert run() == [0] * STEPS


NAMES = ["fedavg", "fedavgm", "fedadam", "fedyogi", "fedadagrad"]


@pytest.mark.parametrize("name", NAMES)
def test_make_server_opt_matches_reference(name, monkeypatch):
    lr = 1.0 if name == "fedavg" else 1e-2
    rcfg = ref_server_opt.ServerOptConfig(name=name, lr=lr)
    pcfg = server_opt.ServerOptConfig(name=name, lr=lr)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    monkeypatch.setattr(torch, "sqrt", _exact_sqrt)
    params = _trees(2, 1, 1.0)[0]
    deltas = _trees(3, STEPS, 1e-3)
    ropt = ref_server_opt.make_server_opt(rcfg)
    popt = server_opt.make_server_opt(pcfg)
    r_state = ropt.init(jax.tree.map(jnp.asarray, params))
    p_state = popt.init(convert.to_tensors(params))
    rp, pp = jax.tree.map(jnp.asarray, params), convert.to_tensors(params)
    for d in deltas:
        r_upd, r_state = ref_server_opt.server_update(
            ropt, r_state, jax.tree.map(jnp.asarray, d), rp)
        p_upd, p_state = server_opt.server_update(
            popt, p_state, convert.to_tensors(d), pp)
        assert _ulps(r_upd, p_upd) == 0
        rp = ref_optim.apply_updates(rp, r_upd)
        pp = optim.apply_updates(pp, p_upd)
    assert _ulps(rp, pp) == 0
    assert int(p_state.step) == int(r_state.step) == STEPS


def test_unknown_server_optimizer_raises():
    with pytest.raises(ValueError, match="unknown server optimizer"):
        server_opt.make_server_opt(server_opt.ServerOptConfig(name="fedsgd"))


def test_downlink_compresses_the_optimizer_update():
    """``sync_k4_fedadam`` with bidirectional compression, 2 rounds: the
    downlink receives FedAdam's update of the mean delta (the state
    carried from round 1), which is not the mean delta itself."""
    s = dataclasses.replace(scenarios.get_scenario("sync_k4_fedadam"),
                            bidirectional=True)
    model, splits = scenarios.default_setting(8)
    eng = engine.FederatedEngine(model, scenarios.build_protocol(s, 2),
                                 splits, engine_cfg=scenarios.build_engine(s),
                                 device="cpu")
    opt = server_opt.make_server_opt(scenarios.build_engine(s).server_opt)
    state = opt.init(eng.server.params)
    seen = []
    agg0, compress0 = eng.aggregate, eng.downlink.compress

    def aggregate(contribs, weights=None):
        seen.append(["agg", agg0(contribs, weights)])
        return seen[-1][1]

    def compress(updates, receivers, transmit):
        seen[-1].append(updates)
        return compress0(updates, receivers, transmit)

    eng.aggregate = aggregate
    eng.downlink.compress = compress
    recs = eng.run(2).records
    assert all(r.down_bytes > 0 for r in recs)
    assert len(seen) == 2
    for _, agg, updates in seen:
        want, state = server_opt.server_update(opt, state, agg.delta_params)
        got = dict(sorted_items(updates))
        mean = dict(sorted_items(agg.delta_params))
        for path, v in sorted_items(want):
            assert torch.equal(got[path], v), path
        assert any(not torch.equal(got[p], mean[p]) for p in got)
    assert int(eng.server_step.state.step) == 2


@pytest.mark.parametrize("name,gain", [("sync_k4_fedadam", 1e-2 / 1e-3),
                                       ("sync_k4_fedavgm", 1.0 / 0.1),
                                       ("sync_k4_fedadagrad", 1e-2 / 1e-3)])
def test_fedopt_runs_match_reference(name, gain):
    cfg, plan, ref_recs, ref_servers, port_recs, port_servers, n_test = \
        sync_runs(name)
    for (idx, _), r in zip(plan, ref_recs):
        assert r.participants == tuple(int(i) for i in idx)
    check_whole_run(cfg, ref_recs, ref_servers, port_recs, port_servers,
                    n_test, gain)
