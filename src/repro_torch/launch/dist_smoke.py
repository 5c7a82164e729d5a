"""Smoke of the multi-process federated backend (``executor="dist"``).

Port of ``scripts/dist_smoke.py``.  The parent runs each named run once
in its own process through the sharded executor on the block layout the
job will have (every worker's local devices, in worker order: ``[cpu,
cpu]`` on the CPU, ``[cuda:0, cuda:0]`` on a machine with one GPU), then
starts ``PROCS`` workers as fresh interpreters with ``REPRO_DIST_*`` set,
a ``torch.distributed`` job over gloo on a localhost port, each running
the same runs with ``executor="dist"``.  It exits non-zero unless every
worker's records (bytes up, accuracy, training loss, participants) and
final server state equal the parent's bit for bit.  A worker that fails
or does not end within ``TIMEOUT_S`` seconds fails the smoke; the others
are then killed.

    PYTHONPATH=src python -m repro_torch.launch.dist_smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dist_smoke   # on CUDA

The runs (``RUNS``), all from seeds, in the reference's settings:

* ``cohort_full``: ``dist_cohort_full`` on ``scripts/dist_smoke.py``'s
  tiny VGG (480 images over 4 clients), 2 rounds;
* ``fsfl``, ``stc``, ``fedavg_nnc``: ``tests/test_dist_fl.py``'s seed-pin
  setting, 2 clients, all of them every round, 2 rounds;
* ``handoff``: its handoff setting, 8 clients, cohorts of 2, ternary
  levels with error feedback, 4 rounds, the client state in the sharded
  store (a client a shard, one hot, so every process spills), so clients
  move between the processes with their state;
* ``async_windowed``: ``async_windowed_b4`` (buffered async, clients
  finishing within 0.5 s train in one ``run_stacked`` call, each row
  against its own server snapshot) on the tiny VGG over 8 clients, 2
  aggregations;
* ``full``: ``sync_full_fedavg_fsfl`` at full width, ``vgg11_thinned``
  on 6,400 CIFAR-like images over 8 clients (560 training images each,
  batch 32: 17 local steps), 2 rounds.

Every run reports its records, the kernel launches of each round (read
at its evaluation), the round walls, the store's counters and the host
ms and bytes of the ``dist.all_gather`` spans by caller.  Both sides run
torch on ``THREADS`` host threads, since oneDNN's CPU reductions may
round otherwise with another count.  ``run_records(inputs=...)`` replaces
a run's own data, initial state and cohorts (the tests pass the
reference's).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

PROCS = 2
TIMEOUT_S = 540
THREADS = 1
PREFIX = "RECORDS "
SRC = Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Run:
    """One run every process makes: ``build()`` -> (model, protocol,
    splits, engine config without its executor)."""
    build: object
    rounds: int
    seed: int


def tiny_setting(num_clients: int, name: str = "dist_smoke"):
    """The reference's dist tests' tiny VGG on 480 synthetic images (4
    classes), drawn with torch generators."""
    from repro_torch.data import federated, synthetic
    from repro_torch.models import cnn

    task = synthetic.ImageTask(name, num_classes=4, channels=3, size=32,
                               prototypes_per_class=2, noise=0.25)
    x, y = synthetic.make_image_dataset(torch.Generator().manual_seed(0),
                                        task, 480)
    splits = federated.split_federated(torch.Generator().manual_seed(1), x,
                                       y, num_clients=num_clients)
    model = cnn.make_vgg("vgg_tiny_comms", [8, 16], 4, 3, dense_width=16,
                         pool_after=(0, 1))
    return model, splits


def full_width_setting():
    """``vgg11_thinned`` on 6,400 CIFAR-like images over 8 clients (560
    training and 120 validation images each, 960 to test), the setting
    of ``chip_smoke.py``'s full-width paths."""
    from repro_torch.data import federated, synthetic
    from repro_torch.models import cnn

    x, y = synthetic.make_image_dataset(torch.Generator().manual_seed(0),
                                        synthetic.CIFAR_LIKE, 6400)
    splits = federated.split_federated(torch.Generator().manual_seed(1), x,
                                       y, 8)
    return cnn.vgg11_thinned(), splits


def _scenario_run(name: str, setting, rounds: int):
    def build():
        from repro_torch import fl
        s = fl.get_scenario(name)
        model, splits = setting()
        s = dataclasses.replace(s, num_clients=splits.num_clients)
        return (model, fl.build_protocol(s, rounds), splits,
                fl.build_engine(s))
    return Run(build, rounds, 42)


# the seed-pin setting's protocols (tests/test_dist_fl.py)
PINS = {
    "fsfl": dict(method="sparse", fixed_sparsity=0.9),
    "stc": dict(method="ternary", error_feedback=True,
                fixed_sparsity=0.9, structured=False),
    "fedavg_nnc": dict(method="none"),
}


def _engine_cfg(cohort_size=None, **kw):
    from repro_torch.fl import EngineConfig, SamplingConfig, ServerOptConfig
    return EngineConfig(sampling=SamplingConfig(cohort_size=cohort_size),
                        server_opt=ServerOptConfig(name="fedavg", lr=1.0),
                        mode="sync", measure_bytes=True, **kw)


def _pin_run(name: str) -> Run:
    def build():
        from repro_torch.core.protocol import ProtocolConfig
        model, splits = tiny_setting(2, "t")
        cfg = ProtocolConfig(name=name, batch_size=32, local_lr=2e-3,
                             **PINS[name])
        return model, cfg, splits, _engine_cfg()
    return Run(build, 2, 7)


def _handoff_run() -> Run:
    def build():
        from repro_torch.core.protocol import ProtocolConfig
        from repro_torch.fl.population import StoreConfig
        model, splits = tiny_setting(8, "t")
        cfg = ProtocolConfig(name="handoff", method="ternary",
                             error_feedback=True, fixed_sparsity=0.9,
                             structured=False, batch_size=32, local_lr=2e-3)
        store = StoreConfig(backend="sharded", shard_size=1,
                            max_hot_shards=1)
        return model, cfg, splits, _engine_cfg(2, store=store)
    return Run(build, 4, 11)


RUNS = {
    "cohort_full": _scenario_run("dist_cohort_full",
                                 lambda: tiny_setting(4), 2),
    **{name: _pin_run(name) for name in PINS},
    "handoff": _handoff_run(),
    "async_windowed": _scenario_run("async_windowed_b4",
                                    lambda: tiny_setting(8), 2),
    "full": _scenario_run("sync_full_fedavg_fsfl", full_width_setting, 2),
}


def server_digest(server) -> str:
    """sha256 of the server state's bytes, leaf by leaf in wire order."""
    from repro_torch.tree import sorted_items
    h = hashlib.sha256()
    for part in (server.params, server.scales, server.bn_state):
        for path, leaf in sorted_items(part):
            h.update(path.encode())
            h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _launches() -> dict:
    from repro_torch.kernels import level_assign as la
    from repro_torch.kernels import scaled_matmul as sm
    return {"level_assign": la.LAUNCHES["level_assign"],
            "scaled_matmul forward": sm.LAUNCHES["forward"],
            "scaled_matmul backward": sm.LAUNCHES["backward"]}


def run_records(name: str, executor: str = "dist", device="cuda", *,
                mesh: list | None = None, inputs: dict | None = None,
                on_engine=None) -> dict:
    """:func:`record_run` of ``RUNS[name]``, with ``inputs[name]`` (its
    ``splits``, ``init_state`` and ``plan``) where ``inputs`` holds it."""
    return record_run(RUNS[name], executor, device, mesh=mesh,
                      over=(inputs or {}).get(name, {}), on_engine=on_engine)


def record_run(run: Run, executor: str = "dist", device="cuda", *,
               mesh: list | None = None, over: dict | None = None,
               on_engine=None) -> dict:
    """Run ``run`` in this process through ``executor`` on ``device``
    (``"sharded"`` needs ``mesh``, the explicit block layout) with torch
    on ``THREADS`` threads; ``over`` may replace its ``splits``,
    ``init_state`` and ``plan``; ``on_engine(engine)`` sees the engine
    before it runs.  -> its records and readings."""
    from repro_torch.fl import FederatedEngine
    from repro_torch.fl.executors import ShardedExecutor
    from repro_torch.kernels import level_assign as la
    from repro_torch.kernels import scaled_matmul as sm

    sharded = executor == "sharded"
    if sharded and mesh is None:
        raise ValueError("the sharded run needs its mesh")
    over = over or {}
    before = torch.get_num_threads()
    # the data too: its generation's CPU ops may round otherwise
    torch.set_num_threads(THREADS)
    try:
        model, cfg, splits, ecfg = run.build()
        splits = over.get("splits", splits)
        ecfg = dataclasses.replace(ecfg, telemetry="trace",
                                   executor="serial" if sharded
                                   else executor)
        eng = FederatedEngine(model, cfg, splits, seed=run.seed,
                              engine_cfg=ecfg, device=device,
                              init_state=over.get("init_state"),
                              plan=over.get("plan"))
        if sharded:
            ex = ShardedExecutor(mesh=mesh)
            ex.bind(eng.local_train.executor.round)
            eng.local_train.executor = ex
        if on_engine is not None:
            on_engine(eng)
        per_round = []
        evaluate = eng.evaluate

        def counted(server):
            acc = evaluate(server)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            per_round.append(_launches())
            return acc

        eng.evaluate = counted
        la.reset_counters()
        sm.reset_counters()
        t0 = time.time()
        res = eng.run(run.rounds)
        wall = time.time() - t0
        store = eng.local_train.store.stats()
        eng.local_train.store.close()
    finally:
        torch.set_num_threads(before)
    gathers: dict = {}
    for sp in res.telemetry.recorder.snapshot():
        if sp.name == "dist.all_gather":
            g = gathers.setdefault(sp.attrs["what"],
                                   {"calls": 0, "ms": 0.0, "bytes": 0})
            g["calls"] += 1
            g["ms"] += sp.dur_ns / 1e6
            g["bytes"] += sp.attrs["bytes"]
    launches, prev = [], dict.fromkeys(_launches(), 0)
    for counts in per_round:
        launches.append({k: counts[k] - prev[k] for k in counts})
        prev = counts
    return {"records": [[r.up_bytes, r.test_acc, r.train_loss,
                         list(r.participants)] for r in res.records],
            "digest": server_digest(res.server),
            "launches": launches,
            "walls_s": [r.wall_s for r in res.records],
            "run_s": wall, "store": store, "all_gather": gathers}


def free_port() -> int:
    """A free localhost TCP port (raises OSError where none can be
    bound)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Job:
    """``procs`` fresh interpreters ``python *argv`` started as one job
    (``REPRO_DIST_*`` set, a free localhost port as the coordinator),
    with ``src`` on their path and their output in temporary files.
    :meth:`wait` collects them."""

    def __init__(self, argv: list[str], procs: int = PROCS):
        self.port = port = free_port()
        base = {k: v for k, v in os.environ.items()
                if not k.startswith("REPRO_DIST_")}
        base["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(SRC), base.get("PYTHONPATH")) if p)
        self._tmp = tempfile.TemporaryDirectory(prefix="repro_torch_dist_")
        self.logs, self.children = [], []
        for pid in range(procs):
            out, err = (open(os.path.join(self._tmp.name, f"{pid}.{s}"),
                             "w+") for s in ("out", "err"))
            self.logs.append((out, err))
            self.children.append(subprocess.Popen(
                [sys.executable, *argv], stdout=out, stderr=err,
                env=dict(base, REPRO_DIST_COORD=f"127.0.0.1:{port}",
                         REPRO_DIST_NPROCS=str(procs),
                         REPRO_DIST_PID=str(pid))))

    def wait(self, timeout: float = TIMEOUT_S
             ) -> list[tuple[int, str, str]]:
        """Wait at most ``timeout`` seconds; one process that fails, or
        the deadline, kills the rest.  -> (exit code, stdout, stderr)
        each, a killed process's code negative."""
        deadline = time.time() + timeout
        try:
            while any(c.poll() is None for c in self.children):
                if (time.time() > deadline or any(
                        c.poll() not in (None, 0) for c in self.children)):
                    break
                time.sleep(0.1)
        finally:
            for c in self.children:
                if c.poll() is None:
                    c.kill()
                c.wait()
        result = []
        for c, (out, err) in zip(self.children, self.logs):
            out.seek(0)
            err.seek(0)
            result.append((c.returncode, out.read(), err.read()))
            out.close()
            err.close()
        self._tmp.cleanup()
        return result


def spawn(argv: list[str], procs: int = PROCS, timeout: float = TIMEOUT_S
          ) -> list[tuple[int, str, str]]:
    """Start ``Job(argv, procs)`` and wait for it."""
    return Job(argv, procs).wait(timeout)


def records_line(stdout: str):
    """The last ``RECORDS`` line's JSON, or None."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith(PREFIX)]
    return json.loads(lines[-1][len(PREFIX):]) if lines else None


def parent_mesh(device) -> list[torch.device]:
    """The job's block layout in one process: each worker's local devices,
    worker after worker."""
    from repro_torch.launch.mesh import make_cohort_mesh
    return make_cohort_mesh(None, device) * PROCS


def worker_argv(runs, device) -> list[str]:
    return ["-m", "repro_torch.launch.dist_smoke", "--worker", "--device",
            str(device), "--runs", ",".join(runs)]


def compare(expected: dict, workers: list) -> list[str]:
    """Where the workers' runs part from the parent's (records and server
    digest); empty when every one is equal bit for bit."""
    bad = []
    for pid, got in enumerate(workers):
        if got is None:
            bad.append(f"worker {pid} printed no records")
            continue
        for name, want in expected.items():
            mine = got.get(name, {})
            for key in ("records", "digest"):
                if mine.get(key) != want[key]:
                    bad.append(f"worker {pid} {name} {key}: "
                               f"{mine.get(key)} != {want[key]}")
    return bad


def worker_main(args) -> int:
    from repro_torch.dist import init_from_env
    ctx = init_from_env()
    out = {name: run_records(name, "dist", args.device)
           for name in args.runs.split(",")}
    print(PREFIX + json.dumps(out), flush=True)
    ctx.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", default="cohort_full",
                    help=f"comma-separated, of {', '.join(RUNS)}")
    ap.add_argument("--worker", action="store_true",
                    help="run as one process of the job (REPRO_DIST_*)")
    args = ap.parse_args(argv)
    unknown = set(args.runs.split(",")) - set(RUNS)
    if unknown:
        ap.error(f"unknown runs {sorted(unknown)} (known: {', '.join(RUNS)})")
    if args.worker:
        return worker_main(args)

    from repro_torch.runtime import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the workers only load the libraries the parent built
        from repro_torch.kernels import build
        build.build_all()
    mesh = parent_mesh(device)
    runs = args.runs.split(",")
    expected = {name: run_records(name, "sharded", device, mesh=mesh)
                for name in runs}
    for name, want in expected.items():
        print(f"parent (sharded, 1 process, mesh {[str(d) for d in mesh]}) "
              f"{name}: {want['records']} walls {want['walls_s']} "
              f"launches {want['launches']}")
    outs = spawn(worker_argv(runs, device))
    workers = []
    for pid, (rc, out, err) in enumerate(outs):
        if rc != 0:
            print(f"worker {pid} failed (exit {rc}):\n{err[-3000:]}")
            print("dist smoke FAILED")
            return 1
        workers.append(records_line(out))
        for name in runs:
            got = (workers[-1] or {}).get(name, {})
            print(f"worker {pid} (dist, {PROCS} processes) {name}: "
                  f"{got.get('records')} walls {got.get('walls_s')} "
                  f"launches {got.get('launches')} store {got.get('store')} "
                  f"all_gather {got.get('all_gather')}")
    bad = compare(expected, workers)
    for line in bad:
        print(line)
    print("dist smoke OK: records identical across the "
          f"{PROCS}-process job and the single-process sharded run"
          if not bad else "dist smoke FAILED: record mismatch")
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
