"""Cohort execution backends: how a batch of ``client_round`` calls runs.

Port of ``repro.fl.executors`` (serial, vmap and sharded backends).  Every
backend takes client-stacked inputs (leading axis = cohort) and returns
the stacked (K, ...) ``RoundOutput`` the uplink consumes, through two
entry points:

* ``run_shared(server, ...)``: the whole batch against ONE server
  snapshot (the sync cohort barrier);
* ``run_stacked(servers, ...)``: row i against its own snapshot
  ``servers[i]`` (an async dispatch window whose members started from
  different server versions).

The backends:

* ``SerialExecutor``: one ``client_round`` per client, outputs stacked in
  cohort order.  The reference the equivalence tests hold the others to,
  and the backend the checks that record a client's steps hook.
* ``VmapExecutor``, the engine default: the whole cohort in one call of
  the round's cohort form (``client_round.cohort``, ``core.protocol``),
  with the clients on an explicit leading axis of every tree, so each
  kernel launches once a step for the cohort.  The reference's
  ``jax.vmap``; ``run_shared`` broadcasts the server to the K rows,
  ``run_stacked`` stacks the snapshots (the reference's stacked axes).
* ``ShardedExecutor``: the vmap backend over a 1-D device mesh
  (``launch.mesh.make_cohort_mesh``).  The cohort is padded to a multiple
  of the mesh size by repeating its last row (``sampling.pad_clients``),
  each contiguous block runs on its own device, and the outputs are
  gathered to the inputs' device with the padded rows dropped.
* ``DistExecutor``: the sharded backend over a multi-process mesh
  (``repro_torch.dist``): the mesh is every process's devices in process
  order, the cohort is padded to a multiple of its size, each process
  runs only the blocks of its own devices, and the outputs come back to
  every process through one host all-gather a call, so the engine's
  uplink and aggregation see the whole cohort everywhere.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.fl.sampling import pad_clients
from repro_torch.launch.mesh import make_cohort_mesh
from repro_torch.obs import trace as obs_trace
from repro_torch.tree import row, stack, tree_map

# the cohort axis: the leading axis of every stacked tree, the one the
# sharded backends split into blocks over the mesh
COHORT_AXIS = "clients"


def _broadcast(server: Any, k: int) -> Any:
    """One server snapshot as K rows, each its own copy."""
    return tree_map(
        lambda x: x.expand((k,) + tuple(x.shape)).contiguous(), server)


class ClientExecutor:
    """Bind ``client_round`` once, then run cohort batches."""

    name: str = "?"

    def bind(self, client_round) -> None:
        raise NotImplementedError

    def run_shared(self, server, pers, cx, cy, cvx, cvy, bidx):
        """Batch vs ONE server snapshot (sync cohort barrier)."""
        raise NotImplementedError

    def run_stacked(self, servers, pers, cx, cy, cvx, cvy, bidx):
        """Batch vs per-row server snapshots (``servers[i]`` for row i)."""
        raise NotImplementedError


class SerialExecutor(ClientExecutor):
    """One ``client_round`` per client, outputs stacked in cohort order."""

    name = "serial"

    def bind(self, client_round) -> None:
        self.round = client_round

    def run_shared(self, server, pers, cx, cy, cvx, cvy, bidx):
        with obs_trace.span("executor.run_shared", backend=self.name,
                            n=int(cx.shape[0])):
            return stack([self.round(server, row(pers, i), cx[i], cy[i],
                                     cvx[i], cvy[i], bidx[i])
                          for i in range(cx.shape[0])])

    def run_stacked(self, servers, pers, cx, cy, cvx, cvy, bidx):
        with obs_trace.span("executor.run_stacked", backend=self.name,
                            n=int(cx.shape[0])):
            return stack([self.round(servers[i], row(pers, i), cx[i],
                                     cy[i], cvx[i], cvy[i], bidx[i])
                          for i in range(cx.shape[0])])


class VmapExecutor(ClientExecutor):
    """The whole cohort in one call of the round's cohort form: the
    engine default."""

    name = "vmap"

    def bind(self, client_round) -> None:
        cohort = getattr(client_round, "cohort", None)
        if cohort is None:
            raise TypeError(f"the {self.name} executor runs a round's "
                            f"cohort form (client_round.cohort); this round "
                            f"has none")
        self.cohort = cohort

    def _run(self, servers, pers, cx, cy, cvx, cvy, bidx):
        return self.cohort(servers, pers, cx, cy, cvx, cvy, bidx)

    def run_shared(self, server, pers, cx, cy, cvx, cvy, bidx):
        n = int(cx.shape[0])
        with obs_trace.span("executor.run_shared", backend=self.name, n=n):
            return self._run(_broadcast(server, n), pers, cx, cy, cvx, cvy,
                             bidx)

    def run_stacked(self, servers, pers, cx, cy, cvx, cvy, bidx):
        with obs_trace.span("executor.run_stacked", backend=self.name,
                            n=int(cx.shape[0])):
            return self._run(stack(list(servers)), pers, cx, cy, cvx, cvy,
                             bidx)


class ShardedExecutor(VmapExecutor):
    """The cohort form with the client axis split across a device mesh.

    ``mesh`` is a list of devices, one block of the padded cohort each
    (the same device may appear more than once); without it the mesh is
    ``make_cohort_mesh(mesh_shape, device)``, by default every visible
    CUDA device.  A block never runs on the CPU unless the mesh names it.
    The padded rows compute a throwaway replica of the last client and are
    dropped, so a ragged cohort behaves as on one device.  One host
    thread drives the blocks one after another, so on several devices
    they overlap only as far as a block's launches run ahead of the host
    and of that block's host syncs."""

    name = "sharded"

    def __init__(self, mesh: list | None = None,
                 mesh_shape: tuple[int, ...] | None = None,
                 device: str | torch.device = "cuda"):
        self.mesh = (list(mesh) if mesh is not None
                     else make_cohort_mesh(mesh_shape, device))
        if not self.mesh:
            raise ValueError("a cohort mesh needs at least one device")
        self.mesh = [torch.device(d) for d in self.mesh]
        self.mesh_size = len(self.mesh)

    def _run(self, servers, pers, cx, cy, cvx, cvy, bidx):
        n = int(cx.shape[0])
        per = -(-n // self.mesh_size)
        trees = pad_clients((servers, pers, cx, cy, cvx, cvy, bidx),
                            per * self.mesh_size)
        home = cx.device
        outs = []
        for b, dev in enumerate(self.mesh):
            block = tree_map(lambda x: x[b * per:(b + 1) * per].to(dev),
                             trees)
            outs.append(self.cohort(*block))
        return tree_map(lambda *ls: torch.cat([x.to(home) for x in ls])[:n],
                        *outs)


class DistExecutor(ShardedExecutor):
    """The sharded cohort program on a multi-process mesh.

    Construction takes the process's ``repro_torch.dist.DistContext``
    (from the ``REPRO_DIST_*`` environment; without one, the
    single-process context, whose mesh is the local devices, so the
    backend is then the sharded one on every visible device) and builds
    the cohort mesh over every process's devices.  Three things differ
    from :class:`ShardedExecutor`:

    * **input**: each process runs only its own blocks
      (:meth:`local_rows`); the stacked inputs are the same on every
      process (the SPMD engine), so a block is a slice of rows the
      process already holds;
    * **output**: the blocks' outputs go to every process in one host
      all-gather a call (``DistContext.all_gather_tree``, span
      ``dist.all_gather`` with ``what="executor.fetch"``) and are put
      back on the inputs' device in block order, the padded rows
      dropped, so the uplink sees the whole cohort everywhere;
    * **ownership**: :meth:`position_owners` gives the process whose
      block trains each cohort position, the contract
      ``repro_torch.dist.CrossHostClientStore`` partitions client state
      by.

    Each block runs the same call on the same rows as the sharded
    backend's, so the records are bit for bit those of a single-process
    sharded run on the same block layout."""

    name = "dist"

    def __init__(self, ctx=None, device: str | torch.device = "cuda"):
        if ctx is None:
            from repro_torch.dist import get_context
            ctx = get_context()
        self.ctx = ctx
        mesh = ctx.cohort_mesh(device)
        super().__init__(mesh=list(mesh))
        # the mesh is in process order, each process's blocks contiguous;
        # one all-gather of equal buffers needs equal block counts
        self.owners = np.asarray(mesh.owners, np.int64)
        counts = np.bincount(self.owners, minlength=ctx.process_count)
        if len(set(counts.tolist())) != 1:
            raise ValueError(f"every process needs as many devices; the "
                             f"mesh gives the processes {counts.tolist()}")
        self.local_blocks = int(counts[0])

    def _per(self, n: int) -> int:
        return -(-n // self.mesh_size)

    def local_rows(self, n: int) -> tuple[int, int]:
        """The ``[lo, hi)`` rows of the padded cohort of ``n`` this
        process's blocks train."""
        rows = self.local_blocks * self._per(n)
        return self.ctx.process_index * rows, (
            self.ctx.process_index + 1) * rows

    def position_owners(self, n: int) -> np.ndarray:
        """The process whose block trains each of ``n`` cohort positions,
        the write-ownership contract of the cross-host store."""
        if n <= 0:
            return np.empty(0, np.int64)
        return np.repeat(self.owners, self._per(n))[:n]

    def _run(self, servers, pers, cx, cy, cvx, cvy, bidx):
        n = int(cx.shape[0])
        per = self._per(n)
        trees = pad_clients((servers, pers, cx, cy, cvx, cvy, bidx),
                            per * self.mesh_size)
        home = cx.device
        lo, hi = self.local_rows(n)
        outs = []
        for b in range(lo // per, hi // per):
            block = tree_map(
                lambda x: x[b * per:(b + 1) * per].to(self.mesh[b]), trees)
            outs.append(self.cohort(*block))
        mine = tree_map(lambda *ls: torch.cat([x.to(home) for x in ls]),
                        *outs)
        # every process's blocks, in process order (one process: its own)
        every = self.ctx.all_gather_tree(mine, "executor.fetch")
        return tree_map(lambda *ls: torch.cat(ls)[:n], *every)


EXECUTORS = ("serial", "vmap", "sharded", "dist")


def make_executor(name: str, *, mesh_shape: tuple[int, ...] | None = None,
                  device: str | torch.device = "cuda") -> ClientExecutor:
    """Build a backend by registry name (``EngineConfig.executor``);
    ``mesh_shape`` and ``device`` (the engine's) place the sharded
    backend's mesh, ``device`` the dist backend's."""
    if name == "serial":
        return SerialExecutor()
    if name == "vmap":
        return VmapExecutor()
    if name == "sharded":
        return ShardedExecutor(mesh_shape=mesh_shape, device=device)
    if name == "dist":
        return DistExecutor(device=device)
    raise ValueError(f"unknown executor: {name!r} (known: "
                     f"{', '.join(EXECUTORS)})")
