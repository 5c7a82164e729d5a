"""Multi-process federated training on a ``torch.distributed`` job.

Port of ``examples/multipod_train.py``, a self-spawning demo of the
engine's ``executor="dist"`` backend (``repro_torch.dist``).  Run with no
``REPRO_DIST_*`` in the environment, the parent

1. runs the engine in this one process through the sharded executor on
   the block layout the job will have (every worker's local devices, in
   worker order: ``[cpu, cpu]`` on the CPU, ``[cuda:0, cuda:0]`` on a
   machine with one GPU);
2. starts ``--procs`` workers as fresh interpreters of this module, one
   gloo job on a localhost port (``launch.dist_smoke.Job``), each running
   the identical engine loop with ``executor="dist"``: the cohort in
   blocks over the job's processes, each client's state with the process
   that trains it (``repro_torch.dist.CrossHostClientStore``);
3. checks every worker's round records and final server state against
   the parent's, bit for bit.

    PYTHONPATH=src python -m repro_torch.examples.multipod_train \\
        [--rounds N] [--procs P] [--device cuda|cpu]

When cohort sampling moves a client to another process, its
error-feedback state moves with it through one host collective.  The
records every process prints are the same: the engine is one program,
and the process layout must not move a byte.  It exits non-zero when a
worker fails or parts from the parent.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.launch import dist_smoke

SEED = 11


def build():
    """-> (model, protocol, splits, engine config): the tiny VGG on 480
    images of a 4-class task over 8 clients, cohorts of 2, sparse FSFL
    with error feedback, FedAvg."""
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.fl import EngineConfig, SamplingConfig, ServerOptConfig

    model, splits = dist_smoke.tiny_setting(8, "multipod")
    cfg = ProtocolConfig(name="fsfl", method="sparse", fixed_sparsity=0.9,
                         error_feedback=True, batch_size=32, local_lr=2e-3)
    eng = EngineConfig(sampling=SamplingConfig(cohort_size=2),
                       server_opt=ServerOptConfig(name="fedavg", lr=1.0),
                       mode="sync", measure_bytes=True)
    return model, cfg, splits, eng


def run_engine(executor: str, rounds: int, device, mesh=None) -> dict:
    """The engine in this process through ``executor`` on ``device``
    (``"sharded"`` on ``mesh``) -> ``dist_smoke.record_run``'s readings:
    records, server digest, launches, walls."""
    return dist_smoke.record_run(dist_smoke.Run(build, rounds, SEED),
                                 executor, device, mesh=mesh)


def _round_lines(who: str, got: dict) -> list[str]:
    return [f"[{who}] round {i}: clients={part} up={up}B acc={acc:.4f}"
            for i, (up, acc, _, part) in enumerate(got["records"], 1)]


def worker_main(rounds: int, device) -> int:
    """One process of the job: the context first, then the shared loop."""
    from repro_torch.launch import require_dist
    ctx = require_dist().init_from_env()
    got = run_engine("dist", rounds, device)
    print(f"[worker {ctx.process_index}/{ctx.process_count}] "
          f"{len(ctx.local_devices(device))} local / "
          f"{len(ctx.global_devices(device))} global devices")
    for line in _round_lines(f"worker {ctx.process_index}", got):
        print(line)
    print(dist_smoke.PREFIX + json.dumps(got), flush=True)
    ctx.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def parent_main(rounds: int, procs: int, device) -> int:
    from repro_torch.launch import require_dist
    require_dist()  # fail early with the friendly message if dist is broken
    if device.type == "cuda":
        # the workers only load the libraries the parent built
        from repro_torch.kernels import build as kernels_build
        kernels_build.build_all()

    print(f"== reference: 1 process, {procs} simulated devices, "
          "sharded backend ==")
    from repro_torch.launch.mesh import make_cohort_mesh
    mesh = make_cohort_mesh(None, device) * procs
    expected = run_engine("sharded", rounds, device, mesh=mesh)
    for line in _round_lines("reference", expected):
        print(line)

    job = dist_smoke.Job(["-m", "repro_torch.examples.multipod_train",
                          "--rounds", str(rounds), "--procs", str(procs),
                          "--device", str(device)], procs)
    print(f"== spawning {procs} worker processes "
          f"(coordinator localhost:{job.port}) ==")
    ok = True
    for pid, (rc, out, err) in enumerate(job.wait()):
        sys.stdout.write("".join(ln + "\n" for ln in out.splitlines()
                                 if not ln.startswith(dist_smoke.PREFIX)))
        if rc != 0:
            print(f"worker {pid} failed (rc={rc}):\n{err[-2000:]}")
            ok = False
            continue
        got = dist_smoke.records_line(out) or {}
        for key in ("records", "digest"):
            if got.get(key) != expected[key]:
                print(f"worker {pid} {key} DIVERGED from the reference:"
                      f"\n  ref: {expected[key]}\n  got: {got.get(key)}")
                ok = False
    if ok:
        print(f"OK: {procs}-process records match the single-process "
              "reference bit-for-bit")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.runtime import resolve_device
    device = resolve_device(args.device)
    if os.environ.get("REPRO_DIST_NPROCS"):
        return worker_main(args.rounds, device)
    return parent_main(args.rounds, args.procs, device)


if __name__ == "__main__":
    sys.exit(main())
