"""The card phase of the example twins (``chip_smoke.py``'s examples
phase): each twin of ``examples/`` and ``scripts/trace_smoke.py`` run
through its own entry point on the card, and held to what a direct call
gives.

* ``federated_cifar --full --rounds 2`` (the thinned VGG11 on 1,920
  images over 4 clients, the example's FSFL configuration) and
  ``--scenario codec_int8_k4`` at the same width: the records and the
  final server state bit for bit those of a direct ``run_federated`` or
  ``run_scenario`` call from the same seeds on the card (card runs
  repeat since cuDNN runs deterministic), each round's kernel launches
  the direct call's, and the checkpoint restoring to the server state
  bit for bit;
* ``quickstart``, then its FSFL configuration on the card against the
  CPU under ``chip_smoke.compare_small_runs`` (the ``small_check`` the
  caller passes);
* ``serve_decode`` (both engines and the gather mean equal),
  ``launch.trace_smoke`` (exit 0) and ``multipod_train --procs 2
  --rounds 2`` (exit 0).

Every failure raises; nothing runs on the CPU in the card's place.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core.fsfl import run_federated
from repro_torch.data import federated, synthetic
from repro_torch.examples import (federated_cifar, multipod_train,
                                  quickstart, serve_decode)
from repro_torch.fl import Scenario, get_scenario, run_scenario
from repro_torch.fl import rounds as rounds_mod
from repro_torch.launch import trace_smoke
from repro_torch.launch.dist_smoke import server_digest
from repro_torch.models import cnn
from repro_torch.tree import sorted_items

DEVICE = "cuda"
FULL_ROUNDS = 2
FULL_IMAGES = 1920       # federated_cifar --full
INT8_SCENARIO = "codec_int8_k4"
# launches a round the phase reports (chip_smoke.LAUNCH_KEYS' names)
REPORTED = ("scaled_matmul forward", "scaled_matmul backward",
            "level_assign", "delta_compress")


def fail(msg: str) -> None:
    raise RuntimeError(f"examples phase: {msg}")


def record_fields(rec) -> tuple:
    """A round record without its wall and telemetry: what two runs from
    the same seeds must give bit for bit."""
    return (rec.round, rec.test_acc, rec.up_bytes, rec.down_bytes,
            rec.cum_bytes, rec.mean_val_acc, rec.update_sparsity,
            rec.train_loss, rec.participants, rec.sim_time_s)


def counted(launch_counts, run):
    """``run()`` with every kernel counter at 0, the counts read after each
    round's evaluation -> (its result, the launches of each round)."""
    from repro_torch.kernels import (delta_apply, delta_compress,
                                     level_assign, row_stats, scaled_matmul)
    per_round = []
    evaluate0 = rounds_mod.Evaluate.__call__

    def evaluate(self, server):
        acc = evaluate0(self, server)
        torch.cuda.synchronize()
        per_round.append(launch_counts())
        return acc

    for mod in (delta_apply, delta_compress, level_assign, row_stats,
                scaled_matmul):
        mod.reset_counters()
    rounds_mod.Evaluate.__call__ = evaluate
    try:
        res = run()
    finally:
        rounds_mod.Evaluate.__call__ = evaluate0
    before = dict.fromkeys(per_round[0] if per_round else (), 0)
    launches = []
    for counts in per_round:
        launches.append({k: counts[k] - before[k] for k in counts})
        before = counts
    return res, launches


def timed(fn):
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def full_splits(clients: int):
    """``federated_cifar --full``'s data, drawn here as the script does."""
    x, y = synthetic.make_image_dataset(torch.Generator().manual_seed(0),
                                        synthetic.CIFAR_LIKE, FULL_IMAGES)
    return federated.split_federated(torch.Generator().manual_seed(1), x, y,
                                     clients)


def check_checkpoint(path: str, res, label: str) -> None:
    """The checkpoint restores to the run's server state bit for bit."""
    back = checkpoint.restore(path)
    want = {"acc": torch.tensor(res.records[-1].test_acc,
                                dtype=torch.float64),
            "params": res.server.params, "scales": res.server.scales,
            "bn_state": res.server.bn_state}
    got = dict(sorted_items(back))
    for path_, leaf in sorted_items(want):
        mine = torch.from_numpy(np.array(got.pop(path_)))
        if not (mine.dtype == leaf.dtype
                and torch.equal(mine, leaf.detach().cpu())):
            fail(f"{label}: checkpoint leaf {path_} is not the server's")
    if got:
        fail(f"{label}: checkpoint holds more leaves: {sorted(got)}")


def twin_against_direct(label: str, argv: list[str], direct, launch_counts,
                        ckpt: str) -> dict:
    """The twin's ``main(argv)`` against ``direct()``, both counted."""
    (twin, twin_l), twin_s = timed(lambda: counted(
        launch_counts, lambda: federated_cifar.main(argv)))
    (ref, ref_l), ref_s = timed(lambda: counted(launch_counts, direct))
    got = [record_fields(r) for r in twin.records]
    want = [record_fields(r) for r in ref.records]
    if got != want:
        fail(f"{label}: records {got} against the direct call's {want}")
    if server_digest(twin.server) != server_digest(ref.server):
        fail(f"{label}: the server state parts from the direct call's")
    if twin_l != ref_l:
        fail(f"{label}: launches {twin_l} against the direct call's {ref_l}")
    check_checkpoint(ckpt, twin, label)
    walls = [r.wall_s for r in twin.records]
    print(f"  {label}: twin {twin_s:.1f} s, direct {ref_s:.1f} s; round "
          f"walls {[round(w, 3) for w in walls]}; up_bytes "
          f"{[r.up_bytes for r in twin.records]}; launches a round "
          f"{[{k: r[k] for k in REPORTED} for r in twin_l]}; records, "
          f"server and checkpoint bit for bit")
    return {"twin_s": twin_s, "direct_s": ref_s, "walls_s": walls,
            "up_bytes": [r.up_bytes for r in twin.records],
            "launches": twin_l}


def protocol_scenario(name: str, cfg, num_clients: int) -> Scenario:
    """A registered-scenario form of ``run_federated(cfg)``: all clients,
    FedAvg at lr 1, sync rounds, the ``"auto"`` codec, every protocol
    field ``cfg``'s."""
    fields = tuple((f.name, getattr(cfg, f.name))
                   for f in dataclasses.fields(cfg))
    return Scenario(name, protocol_overrides=fields, num_clients=num_clients)


def examples_phase(device_line: str, launch_counts, small_check) -> dict:
    """Run every twin on the card (see the module's docstring).
    ``launch_counts()`` reads the kernel counters;
    ``small_check(scenario, model, splits)`` holds a scenario's card run
    to its CPU run.  -> the phase's readings."""
    out = {"device": device_line}
    with tempfile.TemporaryDirectory(prefix="repro_torch_examples_") as tmp:
        ckpt = os.path.join(tmp, "fsfl_server.ckpt")
        out["federated_cifar_full"] = twin_against_direct(
            "federated_cifar --full", [
                "--full", "--rounds", str(FULL_ROUNDS), "--out", ckpt,
                "--device", DEVICE],
            lambda: run_federated(
                cnn.vgg11_thinned(10),
                federated_cifar.protocol(FULL_ROUNDS), full_splits(4),
                FULL_ROUNDS, seed=federated_cifar.SEED, device=DEVICE),
            launch_counts, ckpt)
        scenario = get_scenario(INT8_SCENARIO)
        out[INT8_SCENARIO] = twin_against_direct(
            f"federated_cifar --full --scenario {INT8_SCENARIO}", [
                "--full", "--scenario", INT8_SCENARIO, "--rounds",
                str(FULL_ROUNDS), "--out", ckpt, "--device", DEVICE],
            lambda: run_scenario(
                scenario, rounds=FULL_ROUNDS, seed=federated_cifar.SEED,
                model=cnn.vgg11_thinned(10),
                splits=full_splits(scenario.num_clients), device=DEVICE),
            launch_counts, ckpt)
    for key, kernels in (("federated_cifar_full",
                          ("level_assign", "scaled_matmul forward")),
                         (INT8_SCENARIO, ("delta_compress",))):
        for r, counts in enumerate(out[key]["launches"], 1):
            for k in kernels:
                if counts[k] < 1:
                    fail(f"{key} round {r} launched no {k}")

    _, out["quickstart_s"] = timed(lambda: quickstart.main(
        ["--device", DEVICE]))
    model, splits = quickstart.setting()
    cfg = quickstart.configs()["fsfl"]
    (report, out["quickstart_card_vs_cpu_s"]) = timed(lambda: small_check(
        protocol_scenario("quickstart_fsfl", cfg, splits.num_clients),
        model, splits))
    out["quickstart_card_vs_cpu"] = {k: report[k] for k in (
        "counted", "flips", "params_off", "max_param_diff",
        "max_scale_diff", "differing_levels")}
    print(f"  quickstart: {out['quickstart_s']:.1f} s; card against CPU "
          f"{out['quickstart_card_vs_cpu']}")

    _, out["serve_decode_s"] = timed(lambda: serve_decode.main(
        ["--device", DEVICE]))
    rc, out["trace_smoke_s"] = timed(lambda: trace_smoke.main(
        ["--device", DEVICE]))
    if rc != 0:
        fail(f"trace_smoke exited {rc}")
    rc, out["multipod_train_s"] = timed(lambda: multipod_train.main(
        ["--procs", "2", "--rounds", "2", "--device", DEVICE]))
    if rc != 0:
        fail(f"multipod_train exited {rc}")
    print(f"  twins' walls ({device_line}): " + ", ".join(
        f"{k[:-2]} {v:.1f} s" for k, v in out.items() if k.endswith("_s")))
    return out
