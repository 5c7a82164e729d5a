"""The comparison behind ``chip_smoke.py``'s small-input check, driven on
the CPU.

``compare_small_runs`` holds two recorded runs of a scenario on the tiny
VGG (``record_small_run``: 2 rounds, 3 local steps per client) together,
with the discrete decisions of each client counted apart (top-k flips;
scales that lie apart after another kept sub-epoch, a top-k flip or a
scale step whose gradients parted) and everything else held to the
check's bounds.  A run held against itself passes with nothing counted
apart; a run whose dense products sum in float64 passes, with the one
client whose training took another discrete decision counted apart for
its cause; a run whose dense layers apply their scale twice (``x @ (s^2 *
W)^T``, a fault the kernel's epilogue could make) fails.

The ``gpu`` tests run the card's check (``small_input_check``, cuDNN
deterministic) 10 times on each scenario, and the comparison on 10 runs
of the card's path as the port runs it (which, since the port's entry
points select cuDNN's deterministic algorithms, no longer differ from
run to run); and two card runs of each scenario must put the same bytes
on the wire and end in the same server state, bit for bit.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import fl
from repro_torch.core import protocol
from repro_torch.fl import executors
from repro_torch.fl import rounds as rounds_mod
from repro_torch.models import cnn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs its files in parallel workers,
    and more threads a worker only contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _record(smoke, name, device, *args, **kwargs):
    return smoke.record_small_run(torch, fl, rounds_mod,
                                  fl.get_scenario(name), device, *args,
                                  **kwargs)


def _compare(smoke, name, base, run):
    cfg = fl.build_protocol(fl.get_scenario(name), smoke.SMALL_ROUNDS)
    return smoke.compare_small_runs(torch, cfg, name, base[0], base[1],
                                    run[0], run[1], base[2])


@pytest.mark.parametrize("name", ["sync_full_fedavg_fsfl", "bidi_sync_full"])
def test_run_against_itself_passes(smoke, name):
    base = _record(smoke, name, "cpu")
    again = _record(smoke, name, "cpu")
    report, failures = _compare(smoke, name, base, again)
    assert failures == []
    assert report["flips"] == report["params_off"] == 0
    assert report["counted"] == [0, 0]
    assert report["max_scale_diff"] == 0.0
    assert len(base[1]) == smoke.SMALL_ROUNDS


@pytest.mark.parametrize("name", ["sync_full_fedavg_fsfl", "bidi_sync_full",
                                  "device_encode_int8"])
def test_dense_layer_that_scales_twice_fails(smoke, name, monkeypatch):
    base = _record(smoke, name, "cpu")
    dense = cnn.dense_apply

    def twice(p, x, s=None):
        if s is None or s.ndim != 1:
            return dense(p, x, s)
        return dense({"w": p["w"] * s[:, None], "b": p["b"]}, x, s)

    monkeypatch.setattr(cnn, "dense_apply", twice)
    faulty = _record(smoke, name, "cpu")
    monkeypatch.undo()
    report, failures = _compare(smoke, name, base, faulty)
    assert failures
    assert max(report["counted"]) > smoke.MAX_COUNTED
    assert report["flips"] > smoke.MAX_FLIPS


def _dense_float64(p, x, s=None):
    w = p["w"] if s is None or s.ndim != 1 else p["w"] * s[:, None]
    return (x.double() @ w.double().T).float() + p["b"]


@pytest.mark.parametrize("name", ["sync_full_fedavg_fsfl", "bidi_sync_full"])
def test_dense_products_summed_in_float64_pass(smoke, name, monkeypatch):
    """On one CPU thread (the module's, the float order of the
    convolutions fixed), round 2 has one client whose training takes
    another discrete decision."""
    base = _record(smoke, name, "cpu")
    monkeypatch.setattr(cnn, "dense_apply", _dense_float64)
    other = _record(smoke, name, "cpu")
    monkeypatch.undo()
    report, failures = _compare(smoke, name, base, other)
    assert failures == []
    assert report["max_scale_diff"] > 0
    assert report["counted"][0] == 0 and report["counted"][1] >= 1
    assert all(c["max_scale_level_diff"] <= 1 for r in report["rounds"]
               for c in r["clients"] if not c["counted"])


def test_scale_event_and_cap(smoke):
    def step(g, u):
        return {"grad": {"a": torch.tensor(g), "p": torch.tensor(1.0)},
                "update": {"a": torch.tensor(u), "p": torch.tensor(0.0)}}

    base = [step([1.0, 2.0], [0.1, 0.2]), step([1.0, 2.0], [0.1, 0.2])]
    run = [step([1.0, 2.0 + 1e-7], [0.1, 0.2]),
           step([1.0, 2.01], [0.3, -0.2])]
    event, ratios = smoke.scale_event(base, run)
    assert event == 1 and ratios[0] < 1e-6 < ratios[1]
    assert smoke.scale_event(base, base)[0] is None
    cap = smoke.scale_cap(base, run, event)
    torch.testing.assert_close(cap["a"], torch.tensor([0.4, 0.4]))


def _forced(smoke, name, base, run):
    cfg = fl.build_protocol(fl.get_scenario(name), smoke.SMALL_ROUNDS)
    return smoke.forced_round_check(torch, cfg, base[1], run[1])


def test_forced_run_against_itself_passes(smoke):
    """Round 2 started from the other run's state: a run held against
    itself this way counts nothing apart, every client's weight and scale
    steps recorded."""
    name = "sync_full_fedavg_fsfl"
    train0 = rounds_mod.LocalTrain.train_cohort
    base = _record(smoke, name, "cpu")
    again = _record(smoke, name, "cpu", forced=base[1])
    assert rounds_mod.LocalTrain.train_cohort is train0
    rounds, failures = _forced(smoke, name, base, again)
    assert failures == []
    assert [r["counted"] for r in rounds] == [[], []]
    assert all(len(c) == 3 for x in again[1] for c in x["weight_steps"])


@pytest.mark.parametrize("name", ["sync_full_fedavg_fsfl", "bidi_sync_full"])
def test_forced_rounds_count_every_client_of_a_faulty_model(smoke, name,
                                                            monkeypatch):
    """A dense layer that scales twice parts the clients in their scale
    steps (round 1, the scales start at 1) and from their first weight
    step (round 2): the count of clients apart is over ``MAX_COUNTED``
    in both rounds.  Each carries a cause, so the cause alone cannot tell
    a fault from float noise; the count does."""
    base = _record(smoke, name, "cpu")
    dense = cnn.dense_apply

    def twice(p, x, s=None):
        if s is None or s.ndim != 1:
            return dense(p, x, s)
        return dense({"w": p["w"] * s[:, None], "b": p["b"]}, x, s)

    monkeypatch.setattr(cnn, "dense_apply", twice)
    faulty = _record(smoke, name, "cpu", forced=base[1])
    monkeypatch.undo()
    rounds, _ = _forced(smoke, name, base, faulty)
    for r in rounds:
        assert len(r["counted"]) > smoke.MAX_COUNTED
    assert all("weight step 1" in c["causes"] for c in rounds[1]["counted"])


def test_forced_dense_products_summed_in_float64_stay_in_bounds(
        smoke, monkeypatch):
    """The tiny VGG's float noise, each round from the same start: at most
    one client a round apart, and every bound held."""
    name = "sync_full_fedavg_fsfl"
    base = _record(smoke, name, "cpu")
    monkeypatch.setattr(cnn, "dense_apply", _dense_float64)
    other = _record(smoke, name, "cpu", forced=base[1])
    monkeypatch.undo()
    rounds, failures = _forced(smoke, name, base, other)
    assert failures == []
    assert max(len(r["counted"]) for r in rounds) <= smoke.MAX_COUNTED


def test_reduced_resnet_convolutions_in_float64_part_only_for_causes(
        smoke, monkeypatch):
    """The reduced ResNet of ``chip_smoke.py`` on the CPU, its second run
    with every convolution summed in float64 and rounded to float32, round
    2 from the first run's state: every client that parts carries a cause
    and every other bound holds; the clients counted apart a round are
    printed (two float32 summation orders, no fault: the yardstick for
    the card's count, which ``compare_small_runs`` caps at one)."""
    from repro_torch import data, models
    model, splits = smoke.small_resnet_setting(torch, data, models)
    name = "sync_full_fedavg_fsfl"
    base = _record(smoke, name, "cpu", model, splits)
    conv = torch.nn.functional.conv2d
    monkeypatch.setattr(
        torch.nn.functional, "conv2d",
        lambda x, w, *a, **k: conv(x.double(), w.double(), *a, **k).float())
    other = _record(smoke, name, "cpu", model, splits, forced=base[1])
    monkeypatch.undo()
    rounds, failures = _forced(smoke, name, base, other)
    smoke.print_forced("resnet_t, convolutions in float64", rounds)
    assert failures == []
    assert all(c["causes"] for r in rounds for c in r["counted"])


def test_sign_step_and_weight_event(smoke):
    def step(g, u):
        return {"grad": {"w": torch.tensor(g), "z": torch.zeros(2)},
                "update": {"w": torch.tensor(u), "z": torch.zeros(2)}}

    base = [step([[1.0, 2.0]], [[0.1, 0.2]]), step([[1.0, 2.0]], [[0.1, 0.2]])]
    run = [step([[1.0, 2.0 + 1e-7]], [[0.1, 0.2]]),
           step([[1.0, -2.0]], [[0.1, -0.2]])]
    assert smoke.sign_step(base, run) == 1
    assert smoke.sign_step(base, base) is None
    # the 2-D leaf counts as a weight, the all-zero leaf is left out
    event, ratios = smoke.scale_event(base, run, weights=True)
    assert event == 1 and ratios[0] < 1e-6 < ratios[1]
    assert smoke.scale_event(base, run)[0] is None


def test_recording_leaves_the_stages_as_they_were(smoke):
    def stages():
        return (rounds_mod.Uplink.intake, rounds_mod.ServerStep.__call__,
                rounds_mod.Downlink.compress, executors.SerialExecutor.bind,
                protocol._grad_tree, protocol.apply_updates)

    before = stages()
    _, log, _ = _record(smoke, "device_encode_int8", "cpu")
    assert before == stages()
    # 4 clients a round, 2 sub-epochs of 3 scale steps each
    assert [len(x["scale_steps"]) for x in log] == [4, 4]
    assert all(len(c) == 6 for x in log for c in x["scale_steps"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the scaled_matmul kernel "
                    "has no CPU mode)")


def _dense_scaled_weight(p, x, s=None):
    """The dense route before ``scaled_matmul``: ``x @ (s * W)^T``."""
    w = p["w"] if s is None or s.ndim != 1 else p["w"] * s[:, None]
    return x @ w.T + p["b"]


ROUTES = {"scaled_matmul": None, "scaled_weight": _dense_scaled_weight}
SCENARIOS = ["sync_full_fedavg_fsfl", "device_encode_int8", "bidi_sync_full"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_card_check_passes_ten_runs_in_a_row(smoke, cuda, route, name,
                                             monkeypatch):
    """``small_input_check`` as ``chip_smoke.py`` runs it, on the dense
    route of the kernel and on the one before it."""
    if ROUTES[route]:
        monkeypatch.setattr(cnn, "dense_apply", ROUTES[route])
    cpu_runs = {}
    for _ in range(10):
        smoke.small_input_check(torch, fl, rounds_mod,
                                fl.get_scenario(name), cpu_runs)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_card_runs_with_default_cudnn_pass(smoke, cuda, route, name,
                                          monkeypatch):
    """cuDNN's default algorithms differ from run to run: 10 samples."""
    base = _record(smoke, name, "cpu")
    if ROUTES[route]:
        monkeypatch.setattr(cnn, "dense_apply", ROUTES[route])
    failed = []
    for rep in range(10):
        run = _record(smoke, name, "cuda")
        report, failures = _compare(smoke, name, base, run)
        causes = [(r["round"], c["client"], c["causes"])
                  for r in report["rounds"] for c in r["clients"]
                  if c["counted"]]
        print(f"{name} {route} cuDNN default rep {rep + 1}: counted "
              f"{causes}, max |scale diff| {report['max_scale_diff']:.3g}, "
              f"{report['max_scale_diff_others']:.3g} without them; "
              f"{failures or 'pass'}")
        failed += failures
    assert failed == []


@pytest.mark.gpu
@pytest.mark.parametrize("name", SCENARIOS)
def test_card_runs_repeat_bit_for_bit(smoke, cuda, name):
    """Two card runs of a scenario, with the algorithms the port selects
    (``runtime.resolve_device``: cuDNN deterministic, no autotuning), put
    the same payloads on the wire and end in the same server state, bit
    for bit."""
    report, failures = smoke.repeat_small_runs(torch, fl, rounds_mod, name)
    print(f"{name}: {report}")
    assert failures == []
    assert report["payloads"] > 0
    assert report["cudnn_deterministic"] and not report["cudnn_benchmark"]
