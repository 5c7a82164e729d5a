"""The port's slice end to end against the reference: 2 rounds of
``device_encode_int8`` and of ``codec_int8_k4`` on the reference's
``default_setting`` (tiny VGG, 8 clients, cohorts of 4) with 1,280
samples, so that every client takes 3 local Adam steps a round.  (With a
single step Adam's bias-corrected update is about ``local_lr`` at nearly
every element, the top-k threshold falls among near-ties, and a
comparison of the models says little.)

Both packages start from the same state (the reference's init through
``repro_torch.convert``), train on the same data (the reference's arrays)
and follow the same cohorts and batch orders (drawn with the reference's
key discipline: ``k_init, key = split(key)``, then per round
``key, kb = split(key)`` and ``key, ks = split(key)``).

* ``up_bytes`` must be equal in every round (the payload layout is exact);
* server params after each round: training sums in another order than
  XLA, so an element of one client's update may cross a rounding boundary
  (the mean then moves by at most one quantization step, ``step_size``)
  or the top-k threshold (it moves by that client's whole update).  Every
  element is held to one quantization step, except at most ``MAX_FLIPS``
  top-k flips counted apart, and at most ``MAX_OFF`` elements may differ
  by more than 1e-6.  Both limits are set from observed runs: over three
  data seeds, both rounds and both scenarios no element differed by more
  than 5e-10;
* server scales after round r: within r fine quantization steps (a client's
  scale levels may differ by one per round; the largest seen was 1.25 fine
  steps after round 2).  A sub-epoch accepted on one side and rejected on
  the other moves a scale by its whole delta, up to ~0.09 here;
* test accuracy within one of the 192 test images (equal when seen);
* the kernel wrappers' call counters show the path went through them.

The two rounds run twice, held to these bounds.  Through the serial
executor they run as one trajectory, each round from the port's own
state.  Through the engine's default, the batched executor, each round
starts from the reference's server and client state after the round
before (teacher-forced), the scales of every round within one fine step.
As one trajectory the batched executor's round 2 parts from the
reference's: its grouped convolutions sum in another order, round 1
leaves the clients' state float32 noise apart from the serial one's, and
round 2 turns that noise into scale drift.  So does the serial trajectory with its initial params one ulp
up, further; both are printed as readings.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.protocol import make_protocol as ref_make_protocol
from repro.data.federated import client_epoch_batches
from repro.fl import scenarios as ref_scenarios
from repro.fl.engine import FederatedEngine as RefEngine
from repro.fl.sampling import SamplingConfig, sample_cohort
from repro_torch import convert
from repro_torch.data.federated import FederatedSplits
from repro_torch.fl import engine, scenarios
from repro_torch.kernels import delta_compress as dc
from repro_torch.launch import serve
from repro_torch.models import cnn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROUNDS = 2
N_SAMPLES = 1280
MAX_FLIPS = 5
MAX_OFF = 34         # 0.5% of the 6,786 params


def _flat(tree, to_np=np.asarray):
    return {f"{m}/{n}": to_np(v) for m, d in tree.items() for n, v in d.items()}


@pytest.mark.parametrize("name,kernel,calls_per_round", [
    ("device_encode_int8", "delta_compress_batch", 1),
    ("codec_int8_k4", "delta_compress", 4)])
def test_slice_two_rounds_match_reference(name, kernel, calls_per_round):
    s = ref_scenarios.get_scenario(name)
    cfg = ref_scenarios.build_protocol(s, ROUNDS)
    model, splits = ref_scenarios.default_setting(s.num_clients,
                                                  n_samples=N_SAMPLES)
    n_train = splits.client_x.shape[1]
    steps = max(1, n_train // cfg.batch_size)
    assert steps == 3

    # the reference's key discipline, replayed for the port's plan
    key = jax.random.PRNGKey(42)
    k_init, key = jax.random.split(key)
    plan = []
    for _ in range(ROUNDS):
        key, kb = jax.random.split(key)
        key, ks = jax.random.split(key)
        idx = sample_cohort(ks, s.num_clients,
                            SamplingConfig(cohort_size=s.cohort_size))
        plan.append((idx, np.asarray(client_epoch_batches(
            kb, len(idx), n_train, cfg.batch_size))))
    init, _, _ = ref_make_protocol(model, cfg, steps)
    server0, pers0 = jax.device_get(init(k_init))

    ref = RefEngine(model, cfg, splits, jax.random.PRNGKey(42),
                    ref_scenarios.build_engine(s))
    ref_recs, ref_servers, ref_pers = [], [], []
    for _ in range(ROUNDS):
        ref_recs += ref.run(1).records
        ref_servers.append(jax.device_get(ref.server))
        ref_pers.append(jax.device_get(ref.local_train.persistent))

    port_s = scenarios.get_scenario(name)
    data = FederatedSplits.from_numpy(*jax.device_get(
        (splits.client_x, splits.client_y, splits.client_val_x,
         splits.client_val_y, splits.test_x, splits.test_y)))

    def port_run(executor, forced=False, nudge=False):
        server, pers = convert.initial_state(server0, pers0)
        if nudge:    # every initial param one ulp up
            server = server._replace(params={
                m: {n: torch.nextafter(v, torch.full_like(v, np.inf))
                    for n, v in d.items()} for m, d in server.params.items()})
        port = engine.FederatedEngine(
            cnn.make_vgg("vgg_scenario", [8, 16, 32], 10, 3, dense_width=16,
                         pool_after=(0, 1, 2)),
            scenarios.build_protocol(port_s, ROUNDS), data,
            engine_cfg=dataclasses.replace(scenarios.build_engine(port_s),
                                           executor=executor),
            init_state=(server, pers), plan=plan, device="cpu")
        dc.reset_counters()
        recs, servers = [], []
        for rnd in range(ROUNDS):
            if forced and rnd:
                port.server = convert.server_state(ref_servers[rnd - 1])
                port.local_train.state = convert.client_persistent(
                    ref_pers[rnd - 1])
            recs += port.run(1).records
            servers.append(port.server)
        assert dc.CALLS[kernel] == calls_per_round * ROUNDS
        assert dc.LAUNCHES == {"delta_compress": 0,
                               "delta_compress_batch": 0}
        return recs, servers

    assert port_s.executor == "vmap"
    for executor, forced in (("serial", False), ("vmap", True)):
        _check_rounds(name, cfg, plan, len(splits.test_y), ref_recs,
                      *port_run(executor, forced), ref_servers, forced)
    # readings, not held: the trajectories the forced rounds stand for
    for label, run in (("vmap", dict(executor="vmap")),
                       ("serial, initial params one ulp up",
                        dict(executor="serial", nudge=True))):
        servers = port_run(**run)[1]
        drift = [max(float(np.abs(np.asarray(v.numpy()) - np.asarray(
            ref_srv.scales[m][n])).max()) for m, d in srv.scales.items()
            for n, v in d.items()) / cfg.fine_step_size
            for srv, ref_srv in zip(servers, ref_servers)]
        print(f"{name}, {label}, unforced: server scales "
              f"{', '.join(f'{x:.2f}' for x in drift)} fine steps off the "
              f"reference's, round by round")


def _check_rounds(name, cfg, plan, n_test, ref_recs, port_recs,
                  port_servers, ref_servers, forced):
    for (idx, _), r, p in zip(plan, ref_recs, port_recs):
        assert r.participants == p.participants == tuple(int(i) for i in idx)
        assert p.up_bytes == r.up_bytes
        assert abs(p.test_acc - r.test_acc) <= 1 / n_test + 1e-6

    for rnd, (ref_srv, port_srv) in enumerate(zip(ref_servers, port_servers),
                                              1):
        ref_p, port_p = _flat(ref_srv.params), _flat(port_srv.params,
                                                      lambda v: v.numpy())
        diff = np.concatenate([np.abs(port_p[k] - v).ravel()
                               for k, v in ref_p.items()])
        flips = int(np.sum(diff > cfg.step_size * 1.01))
        off = int(np.sum(diff > 1e-6))
        print(f"{name} round {rnd}{' (forced)' if forced else ''}: max "
              f"|param diff| {diff.max():.3g}, {off} of {diff.size} params "
              f"off by > 1e-6, {flips} flips")
        assert flips <= MAX_FLIPS and off <= MAX_OFF, (rnd, flips, off)
        ref_sc, port_sc = _flat(ref_srv.scales), _flat(port_srv.scales,
                                                        lambda v: v.numpy())
        steps = 1 if forced else rnd
        for k, v in ref_sc.items():
            np.testing.assert_allclose(port_sc[k], v, rtol=0,
                                       atol=steps * cfg.fine_step_size * 1.01,
                                       err_msg=f"round {rnd} scales {k}")


def test_unported_options_raise(capsys):
    """``serve --arch`` runs the transformer family's serving path on the
    CPU; an unknown arch fails as the reference's does (no config module
    of that name); a tensor-parallel context outside a joined job raises
    at its first collective, naming the mesh axis that has no group."""
    from repro.launch import serve as ref_serve
    from repro_torch.models.common import ShardCtx

    lines = serve.main(["--arch", "mamba2-370m", "--steps", "2",
                        "--device", "cpu"])
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("seq")]
    assert printed == lines and [ln[:5] for ln in lines] == ["seq0:",
                                                             "seq1:"]
    assert all(len(eval(ln.split(":", 1)[1])) == 2 for ln in lines)
    with pytest.raises(ModuleNotFoundError, match="repro.configs.gpt2"):
        ref_serve.main(["--arch=gpt2", "--steps", "1"])
    with pytest.raises(ModuleNotFoundError,
                       match="repro_torch.configs.gpt2"):
        serve.main(["--arch=gpt2", "--steps", "1", "--device", "cpu"])
    from repro_torch.models import common
    common.unbind_axes()
    with pytest.raises(RuntimeError, match="mesh axis 'model'"):
        common.sp_all_gather(torch.ones(2, 4, 3),
                             ShardCtx(tp_axis="model", tp_size=2))


def test_no_wire_round_applies_the_mean_reconstruction():
    """``measure_bytes=False``: nothing goes on the wire and the server
    adds the clients' mean device-side reconstruction (FedAvg, lr 1)."""
    model, splits = scenarios.default_setting(8)
    s = scenarios.get_scenario("codec_int8_k4")
    eng = engine.FederatedEngine(
        model, scenarios.build_protocol(s, 1), splits,
        engine_cfg=dataclasses.replace(scenarios.build_engine(s),
                                       measure_bytes=False), device="cpu")
    server0 = eng.server
    captured = {}
    train = eng.local_train.train_cohort

    def spy(*args):
        captured["out"] = out = train(*args)
        return out

    eng.local_train.train_cohort = spy
    rec = eng.run(1).records[0]
    assert rec.up_bytes == 0 and len(rec.participants) == 4
    mean = {m: {n: v.mean(0) for n, v in d.items()}
            for m, d in captured["out"].recon_delta_params.items()}
    for m, d in eng.server.params.items():
        for n, v in d.items():
            assert torch.equal(v, server0.params[m][n] + mean[m][n])
