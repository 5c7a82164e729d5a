"""Cross-host client state: an ownership-partitioned store with handoff.

Port of ``repro.dist.state``.  In a multi-process run each process trains
a contiguous block of the (padded) cohort rows, so only that process sees
those clients' new persistent state.  :class:`CrossHostClientStore` wraps
a per-process store (the in-memory one, or the sharded spill-to-disk one
at population scale) and partitions WRITE ownership by training position:
``scatter`` writes only the rows this process trained, so each process's
inner store holds only the clients it trains.

Reads are collective.  Every process keeps the same map ``client -> the
process that last trained it`` (the schedule is the same everywhere); on
``gather`` each process puts the rows it owns into a cohort-sized buffer,
one all-gather gives every process every buffer, and each row is SELECTED
from its owner's buffer.  (The reference sums the buffers, zeros where a
process does not own the row; a sum turns a ``-0.0`` into ``+0.0``, a
select keeps every bit.)  When sampling moves a client to another
process's block, that gather is the handoff: the old owner ships the row,
the new one trains and writes it, and the map records the move
(``stats()["handoffs"]``).

A client never trained has no owner; every process serves it the
template row, as a cold gather of the sharded store does (a cohort of
such clients only, a run's first, needs no collective).

Every process must call gather and scatter in the same order with the
same indices (the SPMD schedulers do): a diverging call order stalls in
the collective until its timeout, it never mixes states silently.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.fl.population.store import ClientStateStore
from repro_torch.tree import items, rebuild


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


class CrossHostClientStore(ClientStateStore):
    """Ownership-partitioned wrapper over a per-process state store.

    ``owner_fn(n) -> np.ndarray`` maps the ``n`` cohort positions of a
    scatter to the process that trained each row
    (``DistExecutor.position_owners``, from the mesh's blocks).
    ``template`` is one client's state (device tensors); gathers return
    the cohort's rows on its device."""

    name = "crosshost"
    dense = False

    def __init__(self, inner: ClientStateStore, ctx,
                 owner_fn: Callable[[int], np.ndarray], template: Any):
        self.inner = inner
        self.ctx = ctx
        self.owner_fn = owner_fn
        self.num_clients = inner.num_clients
        pairs = items(template)
        self._template = template
        self._paths = [p for p, _ in pairs]
        self._template_leaves = [_host(leaf) for _, leaf in pairs]
        self.device = (pairs[0][1].device
                       if pairs and isinstance(pairs[0][1], torch.Tensor)
                       else torch.device("cpu"))
        # client id -> index of the process that last trained it; the same
        # on every process (deterministic schedule)
        self._owner: dict[int, int] = {}
        self.handoffs = 0       # rows whose owning process changed
        self.cold_gathers = 0   # rows served from the template

    def gather(self, idx) -> Any:
        idx = np.asarray(idx)
        n = len(idx)
        owners = np.asarray([self._owner.get(int(c), -1) for c in idx],
                            np.int64)
        leaves = [np.zeros((n,) + t.shape, t.dtype)
                  for t in self._template_leaves]
        if (owners >= 0).any():
            # every process knows the owners, so all of them skip the
            # collective alike when no row has one
            mine = np.nonzero(owners == self.ctx.process_index)[0]
            buffers = [np.zeros_like(leaf) for leaf in leaves]
            if len(mine):
                rows = self.inner.gather(idx[mine])
                for buf, (_, leaf) in zip(buffers, items(rows)):
                    buf[mine] = _host(leaf)
            every = self.ctx.all_gather_tree(
                [torch.from_numpy(b) for b in buffers], "store.gather")
            for j, leaf in enumerate(leaves):
                for p, got in enumerate(every):
                    sel = owners == p
                    leaf[sel] = got[j].numpy()[sel]
        cold = np.nonzero(owners < 0)[0]
        if len(cold):
            self.cold_gathers += len(cold)
            for leaf, t in zip(leaves, self._template_leaves):
                leaf[cold] = t
        return rebuild(self._template, {
            p: torch.from_numpy(leaf).to(self.device)
            for p, leaf in zip(self._paths, leaves)})

    def scatter(self, idx, rows: Any) -> None:
        idx = np.asarray(idx)
        owners = np.asarray(self.owner_fn(len(idx)), np.int64)
        mine = np.nonzero(owners == self.ctx.process_index)[0]
        if len(mine):
            self.inner.scatter(idx[mine], rebuild(rows, {
                p: leaf[torch.as_tensor(mine, device=leaf.device)]
                for p, leaf in items(rows)}))
        for c, new in zip(idx, owners):
            prev = self._owner.get(int(c))
            if prev is not None and prev != int(new):
                self.handoffs += 1
            self._owner[int(c)] = int(new)

    def stats(self) -> dict[str, int]:
        me = self.ctx.process_index
        out = dict(self.inner.stats())
        out.update(
            handoffs=self.handoffs,
            crosshost_cold_gathers=self.cold_gathers,
            owned_clients=sum(1 for o in self._owner.values() if o == me))
        return out

    def close(self) -> None:
        self.inner.close()
