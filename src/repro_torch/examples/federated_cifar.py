"""End to end: federated training of the paper's thinned VGG11 on
the synthetic CIFAR task (paper §5.6 setting, scaled down).

Port of ``examples/federated_cifar.py``.  Runs the Table-2 pipeline
(fixed-rate sparsification, filter scaling with E sub-epochs and the
accept-if-better rule, uniform quantization, DeepCABAC bytes, FedAvg) and
writes a checkpoint of the final server model in the reference's format
(``repro_torch.checkpoint``; ``repro.checkpoint.restore`` reads it).

    PYTHONPATH=src python -m repro_torch.examples.federated_cifar \\
        [--rounds N] [--clients C] [--full]   (--full: the thinned VGG11)
        [--scenario NAME]        (a registered scenario instead; see
                                  ``repro_torch.fl.list_scenarios()``)
        [--executor serial|vmap|sharded] [--population N]
        [--store memory|sharded] [--traffic PRESET]
        [--telemetry off|metrics|trace] [--trace-out FILE]
        [--metrics-out FILE] [--wire-schema 1|2] [--uplink-workers N]
        [--uplink-batch] [--bidirectional] [--out FILE]
        [--device cuda|cpu]

The flags, defaults and choices are the reference script's; ``--device``
(CUDA unless ``cpu``) is the one flag added.  The data and the initial
state come from torch generators seeded as the reference's keys are
numbered (data 0, split 1, run 42).  :func:`run` takes the model and the
splits and may take the initial state and the batch plan, so a test can
feed it the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import checkpoint
from repro_torch.core.fsfl import run_federated
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.data import federated, synthetic
from repro_torch.fl import (TRAFFIC_PRESETS, get_scenario, list_scenarios,
                            run_scenario)
from repro_torch.models import cnn
from repro_torch.runtime import resolve_device

SEED = 42
SCENARIO_ONLY = ("wire_schema", "uplink_workers", "uplink_batch", "executor",
                 "population", "store", "traffic", "telemetry", "trace_out",
                 "metrics_out")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=None,
                    help="default: 10, or the scenario's registered rounds")
    ap.add_argument("--clients", type=int, default=None,
                    help="default: 4, or the scenario's client count")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--bidirectional", action="store_true")
    ap.add_argument("--scenario", choices=list_scenarios(), default=None)
    ap.add_argument("--wire-schema", type=int, choices=(1, 2), default=None,
                    help="2 = BN statistics travel inside every codec "
                         "payload (scenario runs only)")
    ap.add_argument("--uplink-workers", type=int, default=None,
                    help="parallel per-client wire encode+decode "
                         "(scenario runs only)")
    ap.add_argument("--uplink-batch", action="store_true",
                    help="cohort-batched uplink: code the whole cohort "
                         "through the codec batch API in <= workers pool "
                         "tasks (scenario runs only)")
    ap.add_argument("--executor", choices=("serial", "vmap", "sharded"),
                    default=None,
                    help="cohort execution backend: one client at a time, "
                         "the cohort in one call (default), or the cohort "
                         "in blocks over the visible devices (scenario "
                         "runs only)")
    ap.add_argument("--population", type=int, default=None,
                    help="virtual population size: the scenario's --clients "
                         "data shards back this many hash-mapped clients; "
                         "per-client state lives in the configured store "
                         "(scenario runs only; sync scenarios need a "
                         "cohort_size)")
    ap.add_argument("--store", choices=("memory", "sharded"), default=None,
                    help="client-state backend: eager in-memory or "
                         "sharded+lazy with LRU spill-to-disk (scenario "
                         "runs only)")
    ap.add_argument("--traffic", choices=sorted(TRAFFIC_PRESETS),
                    default=None,
                    help="trace-driven traffic preset: diurnal availability "
                         "curves / device-class latency / mid-round churn "
                         "(scenario runs only)")
    ap.add_argument("--telemetry", choices=("off", "metrics", "trace"),
                    default=None,
                    help="round-lifecycle telemetry: per-round metrics "
                         "snapshots, or full span tracing (scenario runs "
                         "only)")
    ap.add_argument("--trace-out", default=None,
                    help="write the recorded spans as Chrome trace-event "
                         "JSON (open at https://ui.perfetto.dev; implies "
                         "--telemetry trace)")
    ap.add_argument("--metrics-out", default=None,
                    help="stream per-round metrics snapshots to this JSONL "
                         "file (implies --telemetry metrics)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "fsfl_server.ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def parse(argv=None):
    """-> (args, the scenario or None), with the reference's defaults
    filled in and its flag errors."""
    ap = parser()
    args = ap.parse_args(argv)
    scenario = get_scenario(args.scenario) if args.scenario else None
    if scenario is None and any(
            getattr(args, f) not in (None, False) for f in SCENARIO_ONLY):
        ap.error("--wire-schema/--uplink-workers/--uplink-batch/--executor/"
                 "--population/--store/--traffic/--telemetry/--trace-out/"
                 "--metrics-out need --scenario")
    if args.trace_out is not None:
        args.telemetry = "trace"
    elif args.metrics_out is not None and args.telemetry is None:
        args.telemetry = "metrics"
    if args.clients is None:
        args.clients = scenario.num_clients if scenario else 4
    if args.rounds is None and scenario is None:
        args.rounds = 10  # scenario runs: None takes the registered rounds
    return args, scenario


def setting(args):
    """-> (model, splits): 1,920 (``--full``) or 640 CIFAR-like images over
    ``args.clients`` clients, the thinned VGG11 or a small VGG."""
    x, y = synthetic.make_image_dataset(torch.Generator().manual_seed(0),
                                        synthetic.CIFAR_LIKE,
                                        1920 if args.full else 640)
    splits = federated.split_federated(torch.Generator().manual_seed(1), x,
                                       y, args.clients)
    model = (cnn.vgg11_thinned(10) if args.full else
             cnn.make_vgg("vgg_small", [8, 16, 32], 10, 3, dense_width=16,
                          pool_after=(0, 1, 2)))
    return model, splits


def protocol(rounds: int) -> ProtocolConfig:
    """The example's FSFL configuration (runs without ``--scenario``)."""
    return ProtocolConfig(
        name="fsfl", method="sparse", scaling=True, error_feedback=True,
        fixed_sparsity=0.96, structured=False, scale_subepochs=2,
        scale_lr=2e-2, scale_schedule="cawr", batch_size=32, local_lr=2e-3,
        total_rounds=rounds)


def with_flags(scenario, args):
    """``scenario`` with the flags that override it."""
    over = {}
    if args.bidirectional:
        over["bidirectional"] = True
    for field in ("wire_schema", "uplink_workers", "executor", "population",
                  "store"):
        if getattr(args, field) is not None:
            over[field] = getattr(args, field)
    if args.uplink_batch:
        over["uplink_batch"] = True
    if args.traffic is not None:
        over["traffic"] = TRAFFIC_PRESETS[args.traffic]
    if args.telemetry is not None:
        over.update(telemetry=args.telemetry, metrics_out=args.metrics_out)
    return dataclasses.replace(scenario, **over)


def run(args, scenario, model, splits, *, init_state=None, plan=None,
        device=None):
    """The run ``args`` asks for on ``device``: the scenario with its
    flags, or ``run_federated`` with :func:`protocol`; prints the
    reference script's lines and writes the checkpoint to ``args.out``.
    -> the RunResult."""
    if scenario is not None:
        res = run_scenario(with_flags(scenario, args), rounds=args.rounds,
                           seed=SEED, model=model, splits=splits,
                           init_state=init_state, plan=plan, device=device,
                           verbose=True)
        if args.trace_out is not None:
            n = res.telemetry.export_chrome_trace(args.trace_out)
            print(f"trace: {args.trace_out} ({n} events; open at "
                  "https://ui.perfetto.dev)")
    else:
        res = run_federated(model, protocol(args.rounds), splits,
                            args.rounds, seed=SEED,
                            bidirectional=args.bidirectional,
                            init_state=init_state, plan=plan, device=device,
                            verbose=True)
    final = res.records[-1]
    print(f"\nfinal acc={final.test_acc:.3f} "
          f"bytes={final.cum_bytes/1e6:.3f} MB "
          f"sparsity={final.update_sparsity:.3f}")
    # checkpoint the final server model (restore with checkpoint.restore,
    # or the reference's repro.checkpoint.restore)
    n = checkpoint.save(args.out, {
        "acc": final.test_acc,
        "params": res.server.params,
        "scales": res.server.scales,
        "bn_state": res.server.bn_state,
    })
    print(f"checkpoint: {args.out} ({n} bytes)")
    return res


def main(argv=None):
    args, scenario = parse(argv)
    device = resolve_device(args.device)
    model, splits = setting(args)
    return run(args, scenario, model, splits, device=device)


if __name__ == "__main__":
    main()
