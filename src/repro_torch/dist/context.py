"""Multi-process runtime context: ``torch.distributed`` init and topology.

Port of ``repro.dist.context``.  One :class:`DistContext` per process
describes its place in a job: the coordinator's address, the process
index and count, the cohort mesh over every process's devices, and the
host collectives the dist executor and the cross-host client-state store
use.  The FL engine stays one SPMD program that every process runs alike
(the same generator draws, scheduler decisions and byte accounting); only
which cohort rows a process trains, and which client states it keeps,
differ.

Configuration comes from an explicit :class:`DistConfig` or from the
environment (the launchers' contract; ``repro_torch.launch.dist_smoke``
starts its workers with these set):

* ``REPRO_DIST_COORD``: the coordinator's address, ``host:port``
  (process 0 listens there, the others connect);
* ``REPRO_DIST_NPROCS``: the process count;
* ``REPRO_DIST_PID``: this process's index (the coordinator is 0).

A process with no ``REPRO_DIST_*`` environment (and no process group of
its own) gets the single-process context: ``process_count == 1``, the
mesh is the local devices, and every collective is the identity.

**The collectives run on the host, over gloo.**  The reference's are
host-tree collectives too (``process_allgather`` of host numpy, and the
executor's outputs fetched to the host).  NCCL would keep them on the
card, but it refuses two ranks on one GPU, and the machine the port is
measured on has one H100 that both processes share; NCCL on a machine
with a card a process is a speed lever (ROADMAP.md), not an option here.
Each collective packs a whole tree into one byte buffer, so a call is
one ``all_gather`` whatever its leaves; the span ``dist.all_gather``
times each, with its caller and bytes.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import torch

from repro_torch.obs.trace import span
from repro_torch.tree import items, rebuild

ENV_COORD = "REPRO_DIST_COORD"
ENV_NPROCS = "REPRO_DIST_NPROCS"
ENV_PID = "REPRO_DIST_PID"
# a collective (or the group's rendezvous) that waits longer fails
TIMEOUT_S = 120.0
_ALIGN = 8      # each leaf's bytes start at a multiple of its element size


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """One process's slot in a job.

    ``num_processes == 1`` (the default) starts no process group; more
    need ``coordinator`` (``host:port``: process 0 listens, every process
    connects)."""
    coordinator: str | None = None
    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_env(cls) -> "DistConfig | None":
        """The launcher contract; None when no REPRO_DIST_* vars are set."""
        if ENV_COORD not in os.environ and ENV_NPROCS not in os.environ:
            return None
        coord = os.environ.get(ENV_COORD)
        nprocs = int(os.environ.get(ENV_NPROCS, "1"))
        pid = int(os.environ.get(ENV_PID, "0"))
        return cls(coordinator=coord, num_processes=nprocs, process_id=pid)

    def validate(self) -> None:
        if self.num_processes < 1:
            raise ValueError(
                f"num_processes must be >= 1, got {self.num_processes}")
        if not 0 <= self.process_id < self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} out of range for "
                f"{self.num_processes} processes")
        if self.num_processes > 1 and not self.coordinator:
            raise ValueError(
                "a multi-process job needs a coordinator address "
                f"({ENV_COORD} or DistConfig.coordinator, host:port)")


def _group():
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


class DistContext:
    """The process's view of the job (and the single-process case).

    Construction starts the process group once a process when the config
    is multi-process; the topology is then read back from it, whether this
    context or someone else started it."""

    def __init__(self, cfg: DistConfig | None = None):
        if cfg is None:
            cfg = DistConfig.from_env() or DistConfig()
        cfg.validate()
        self.cfg = cfg
        if cfg.num_processes > 1:
            _initialize_once(cfg)
        group = _group()
        self.process_index = group.get_rank() if group else 0
        self.process_count = group.get_world_size() if group else 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0

    def local_devices(self, device: str | torch.device = "cuda"
                      ) -> list[torch.device]:
        """This process's devices on ``device``'s platform: the visible
        CUDA devices, or the CPU."""
        from repro_torch.launch.mesh import make_cohort_mesh
        return make_cohort_mesh(None, device)

    def global_devices(self, device: str | torch.device = "cuda"
                       ) -> list[tuple[int, torch.device]]:
        """(process index, device) of every process's local devices, in
        process order."""
        local = [str(d) for d in self.local_devices(device)]
        every = [local]
        if self.process_count > 1:
            every = [None] * self.process_count
            _group().all_gather_object(every, local)
        return [(p, torch.device(d)) for p, devs in enumerate(every)
                for d in devs]

    def cohort_mesh(self, device: str | torch.device = "cuda"):
        """1-D cohort mesh over every device of every process."""
        from repro_torch.launch.mesh import make_multihost_cohort_mesh
        return make_multihost_cohort_mesh(device, ctx=self)

    # -- host collectives --------------------------------------------------

    def all_gather_tree(self, tree: Any, what: str = "tree") -> list[Any]:
        """Every process's ``tree``, in process order, its leaves on this
        process's copy's devices.  The trees must have one structure,
        dtypes and shapes in every process (the SPMD engine's); the leaves
        travel as one host byte buffer in one gloo ``all_gather``, under
        the span ``dist.all_gather`` (``what`` names the caller, ``bytes``
        what arrived).  At one process, ``[tree]``."""
        if self.process_count == 1:
            return [tree]
        pairs = items(tree)
        sizes = [x.numel() * x.element_size() for _, x in pairs]
        padded = [n + (-n % _ALIGN) for n in sizes]
        total = sum(padded) * self.process_count
        with span("dist.all_gather", what=what, leaves=len(pairs),
                  bytes=total):
            parts = []
            for (_, x), n, m in zip(pairs, sizes, padded):
                parts.append(x.detach().contiguous().reshape(-1).view(
                    torch.uint8))
                if m > n:
                    parts.append(parts[-1].new_zeros(m - n))
            buf = (torch.cat(parts).cpu() if parts
                   else torch.zeros(0, dtype=torch.uint8))
            out = [torch.empty_like(buf) for _ in range(self.process_count)]
            _group().all_gather(out, buf)
            trees = []
            for got in out:
                by_path, off, on = {}, 0, {}
                for (path, x), n, m in zip(pairs, sizes, padded):
                    if x.device not in on:      # one copy a device
                        on[x.device] = got.to(x.device)
                    by_path[path] = on[x.device][off:off + n].view(
                        x.dtype).reshape(x.shape)
                    off += m
                trees.append(rebuild(tree, by_path))
        return trees

    def sum_across_processes(self, tree: Any) -> Any:
        """Elementwise sum of each process's ``tree`` (identity at one
        process), the reference's helper.  The cross-host store does not
        use it: a sum turns a ``-0.0`` into ``+0.0``, where selecting the
        owner's row keeps every bit."""
        trees = self.all_gather_tree(tree, "sum")
        if len(trees) == 1:
            return tree
        from repro_torch.tree import tree_map
        return tree_map(lambda *xs: sum(xs[1:], xs[0]), *trees)

    def barrier(self) -> None:
        """Block until every process reaches the same point (no-op at one
        process)."""
        if self.process_count > 1:
            _group().barrier()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"DistContext(process {self.process_index}/"
                f"{self.process_count})")


# --------------------------------------------------------------- singleton

_CONTEXT: DistContext | None = None


def _initialize_once(cfg: DistConfig) -> None:
    """``init_process_group`` once a process (gloo, a finite timeout),
    with an actionable error where the coordinator cannot be reached."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{cfg.coordinator}",
            world_size=cfg.num_processes, rank=cfg.process_id,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    except Exception as e:  # noqa: BLE001 - re-raise with launch context
        raise RuntimeError(
            f"torch.distributed.init_process_group failed for process "
            f"{cfg.process_id}/{cfg.num_processes} "
            f"(coordinator {cfg.coordinator!r}): {e}. "
            "If this host cannot open the coordinator's socket, run "
            "single-process (drop the REPRO_DIST_* environment).") from e


def get_context() -> DistContext:
    """The process-wide context (made on first use, from the
    environment)."""
    global _CONTEXT
    if _CONTEXT is None:
        _CONTEXT = DistContext()
    return _CONTEXT


def init_from_env() -> DistContext:
    """The launchers' entry point: :func:`get_context`, but raises when
    REPRO_DIST_* is absent (a worker that expected a job should not run
    single-process by itself)."""
    cfg = DistConfig.from_env()
    if cfg is None:
        raise RuntimeError(
            f"init_from_env: no {ENV_COORD}/{ENV_NPROCS} in the "
            "environment; use get_context() for the single-process path")
    global _CONTEXT
    if _CONTEXT is None:
        _CONTEXT = DistContext(cfg)
    return _CONTEXT
