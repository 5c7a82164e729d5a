"""The cohort mesh of the sharded executor.

Port of ``repro.launch.mesh.make_cohort_mesh``: a 1-D mesh over the
federated cohort axis.  Where the reference builds a ``jax`` mesh, the
port's mesh is the list of ``torch.device``s the cohort's blocks run on,
one block a device (``fl.executors.ShardedExecutor``).  The multi-process
mesh (:func:`make_multihost_cohort_mesh`) is the same list over every
process's devices, each entry with the process that owns it.  The
reference's ``make_mesh`` and ``make_production_mesh`` belong to transformer
tensor parallelism, not ported yet (ROADMAP.md, "transformer tensor
parallel").
"""
from __future__ import annotations

import torch


def device_count() -> int:
    """Devices a cohort mesh may span: the visible CUDA devices, or the
    CPU alone where there is none."""
    return torch.cuda.device_count() or 1


def make_cohort_mesh(mesh_shape: tuple[int, ...] | None = None,
                     device: str | torch.device = "cuda"
                     ) -> list[torch.device]:
    """1-D mesh over the cohort axis on ``device``'s platform.

    For CUDA, ``mesh_shape=None`` takes every visible device; an explicit
    shape must be 1-D and fit the visible device count (the first ones).
    For the CPU, which is one device, the mesh is the CPU, ``mesh_shape``
    (1,) or None; a caller who wants the CPU named more than once (to
    shard a cohort into blocks on one host) passes its own list to the
    executor."""
    platform = torch.device(device).type
    if mesh_shape is not None and (len(mesh_shape) != 1
                                   or mesh_shape[0] < 1):
        raise ValueError(f"cohort mesh is 1-D (the client axis); got shape "
                         f"{mesh_shape!r}")
    if platform == "cuda":
        have = torch.cuda.device_count()
        if have == 0:
            raise RuntimeError("a CUDA cohort mesh needs a visible CUDA "
                               "device, and there is none")
        devices = [torch.device("cuda", i) for i in range(have)]
    elif platform == "cpu":
        devices = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported device {device!s}: use 'cuda' or "
                         f"'cpu'")
    need = len(devices) if mesh_shape is None else mesh_shape[0]
    if need > len(devices):
        raise ValueError(f"mesh_shape {mesh_shape!r} needs {need} devices "
                         f"but {len(devices)} {platform} devices are "
                         f"visible")
    return devices[:need]


class CohortMesh(list):
    """A cohort mesh over several processes: the devices, in process
    order, and ``owners[i]``, the index of the process that owns entry
    ``i`` (the same ``cuda:0`` may be two processes' entries).  As a list
    it is the plain mesh, so a single process's equals
    :func:`make_cohort_mesh`'s."""

    def __init__(self, devices, owners):
        super().__init__(devices)
        self.owners = [int(o) for o in owners]
        if len(self.owners) != len(self):
            raise ValueError(f"{len(self)} mesh entries but "
                             f"{len(self.owners)} owners")


def make_multihost_cohort_mesh(device: str | torch.device = "cuda",
                               ctx=None) -> CohortMesh:
    """1-D cohort mesh spanning every local device of every process.

    ``ctx`` is the process's ``repro_torch.dist.DistContext`` (by default
    ``get_context()``); each process's local devices on ``device``'s
    platform are gathered from all of them.  Raises where the mesh does
    not cover every process of the job (a worker that did not join would
    otherwise shard over its own devices only and part from the others).
    In a single process it is exactly ``make_cohort_mesh(None, device)``.
    """
    if ctx is None:
        from repro_torch.dist import get_context
        ctx = get_context()
    entries = ctx.global_devices(device)
    procs = sorted({p for p, _ in entries})
    if procs != list(range(ctx.process_count)):
        raise RuntimeError(
            f"multi-process cohort mesh covers processes {procs} but the "
            f"job has {ctx.process_count}: the process group is not fully "
            f"joined")
    return CohortMesh([d for _, d in entries], [p for p, _ in entries])
