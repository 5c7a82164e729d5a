"""Meshes: the transformer's process mesh and the cohort mesh of the
sharded executor.

Port of ``repro.launch.mesh``.

* :func:`make_mesh` and :func:`make_production_mesh` build the mesh of
  transformer tensor parallelism over the processes of one
  ``torch.distributed`` job, one process a mesh entry, ranks laid out in
  row-major order over the shape (as ``jax.make_mesh`` lays out its
  devices).  The mesh is the port's own ranks and groups, not
  ``torch.distributed.device_mesh``: a ``DeviceMesh`` of device type
  ``cuda`` binds each rank to a card of its own, and the port's tp
  workers share one card over gloo.  Every group (one per line of each
  axis, and along each axis the blocks of ``r`` consecutive ranks that
  stand for the reference's ``axis_index_groups``) is made once, by every
  process, in the same order; each axis this process lies on is bound to
  its name in ``models.common`` (``bind_axis``), where a ``ShardCtx``
  naming it finds its group.
* :func:`make_cohort_mesh`: a 1-D mesh over the federated cohort axis.
  Where the reference builds a ``jax`` mesh, the port's mesh is the list
  of ``torch.device``s the cohort's blocks run on, one block a device
  (``fl.executors.ShardedExecutor``).  The multi-process mesh
  (:func:`make_multihost_cohort_mesh`) is the same list over every
  process's devices, each entry with the process that owns it.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch


def production_shape(multi_pod: bool = False
                     ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the production mesh: 16 x 16 = 256 chips a
    pod; 2 pods = 512."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@dataclasses.dataclass
class Mesh:
    """A mesh over the processes of one job, as the reference's
    ``jax.sharding.Mesh`` over its devices: ``ranks`` (nested lists of
    ``shape``) in place of ``devices``.  This process's groups are bound
    to the axis names in ``models.common``."""
    shape: tuple
    axis_names: tuple
    ranks: list

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _job() -> tuple[int, int]:
    """(rank, world size) of this process's job; (0, 1) outside one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(shape: tuple, axes: tuple) -> Mesh:
    """The mesh of ``shape`` with axis names ``axes`` over this job's
    processes (``prod(shape)`` of them; raises ``ValueError`` naming both
    sizes otherwise), its groups made and its axes bound."""
    from repro_torch.models import common
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} has {len(shape)} axes but "
                         f"{len(axes)} names {axes}")
    rank, world = _job()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs "
                         f"{math.prod(shape)} processes but the job has "
                         f"{world}")
    coords_of = list(itertools.product(*(range(n) for n in shape)))
    coords = coords_of[rank]
    flat = {c: i for i, c in enumerate(coords_of)}
    common.unbind_axes()
    for a, (name, n) in enumerate(zip(axes, shape)):
        others = [range(m) for b, m in enumerate(shape) if b != a]
        mine, blocks = None, {}
        for rest in itertools.product(*others):
            line = [flat[rest[:a] + (i,) + rest[a:]] for i in range(n)]
            group = _new_group(line) if n > 1 else None
            if rank in line:
                mine = group
            for r in (d for d in range(2, n) if n % d == 0):
                for b in range(n // r):
                    block = line[b * r:(b + 1) * r]
                    g = _new_group(block)
                    if rank in block:
                        blocks[r] = g
        common.bind_axis(common.Axis(name, mine, coords[a], n, blocks))
    return Mesh(shape, axes, torch.arange(world).reshape(shape).tolist())


def _new_group(ranks: list[int]):
    """``new_group(ranks)``: every process of the job must call it, in
    the same order, whether it is in ``ranks`` or not."""
    import torch.distributed as dist
    return dist.new_group(ranks)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: (16, 16) ``("data", "model")``,
    or (2, 16, 16) ``("pod", "data", "model")`` across two pods."""
    return make_mesh(*production_shape(multi_pod))


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
