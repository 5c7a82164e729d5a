"""Client-state stores: where a population's per-client FL state lives.

Port of ``repro.fl.population.store``.  Every client owns state that
persists across rounds (its Eq. 5 residual, its local and scale optimizer
states, its schedule counter: ``core.protocol.ClientPersistent``).  A
:class:`ClientStateStore` sits between ``rounds.LocalTrain`` and that
state, so the backend is an engine axis (``EngineConfig.store``):

* :class:`InMemoryStore`: the whole client-stacked tree on the device,
  the single-client template repeated over the clients; a gather indexes
  it by the cohort's rows and a scatter writes them back in place.  The
  right backend for small populations.
* :class:`ShardedLazyStore`: clients partitioned into fixed-size shards
  (``client // shard_size``), each one host numpy tree, materialized only
  when one of its clients is first *written*.  An LRU keeps at most
  ``max_hot_shards`` shards in memory; an evicted shard spills to disk
  through ``repro_torch.checkpoint.io`` (the reference's file format) and
  is loaded again on demand.  A client never written costs nothing: a
  gather serves it the template row.  Memory is O(max_hot_shards *
  shard_size) rows, whatever the population.

Both take and give client-stacked trees of device tensors: the sharded
store's gather crosses to the device in one copy a leaf for the whole
cohort, and its scatter comes back in one copy a leaf.  The two are
bitwise the same through the engine (``tests/test_torch_population.py``).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import weakref
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.obs.trace import span
from repro_torch.tree import items, rebuild, tree_map


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Client-state backend selection (``EngineConfig.store``).

    ``spill_dir=None`` creates a private temporary directory, removed when
    the store is garbage-collected or ``close()``-d.  ``spill_level`` is
    the checkpoint compression level (1: fast)."""
    backend: str = "memory"        # "memory" | "sharded"
    shard_size: int = 64           # clients per shard (sharded backend)
    max_hot_shards: int = 16       # LRU capacity before spilling to disk
    spill_dir: str | None = None   # None = private tempdir
    spill_level: int = 1

    def validate(self) -> None:
        if self.backend not in STORES:
            known = ", ".join(sorted(STORES))
            raise ValueError(f"unknown store backend: {self.backend!r} "
                             f"(known: {known})")
        if self.shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {self.shard_size}")
        if self.max_hot_shards < 1:
            raise ValueError(
                f"max_hot_shards must be >= 1, got {self.max_hot_shards}")


class ClientStateStore:
    """Protocol: client-stacked state keyed by client id.

    ``gather(idx)`` returns the rows of ``idx`` stacked on a leading axis
    (the layout the executors take), ``scatter(idx, rows)`` writes a
    cohort's updated rows back.  ``dense`` marks a backend whose whole
    stacked tree exists (``state``), which ``LocalTrain`` hands to the
    executor as it is under full participation."""

    name: str = "?"
    dense: bool = False
    num_clients: int = 0

    def gather(self, idx) -> Any:
        raise NotImplementedError

    def scatter(self, idx, rows: Any) -> None:
        raise NotImplementedError

    def stats(self) -> dict[str, int]:
        return {}

    def close(self) -> None:
        pass


def _rows(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), dtype=torch.long, device=device)


class InMemoryStore(ClientStateStore):
    """The whole client-stacked tree on the template's device."""

    name = "memory"
    dense = True

    def __init__(self, template: Any, num_clients: int):
        self.num_clients = num_clients
        self._state = tree_map(
            lambda x: x.expand((num_clients,) + tuple(x.shape)).clone(),
            template)

    @property
    def state(self) -> Any:
        return self._state

    def set_state(self, state: Any) -> None:
        self._state = state

    def gather(self, idx) -> Any:
        return tree_map(lambda x: x[_rows(idx, x.device)], self._state)

    def scatter(self, idx, rows: Any) -> None:
        def put(full, r):
            full[_rows(idx, full.device)] = r
            return full

        self._state = tree_map(put, self._state, rows)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


class ShardedLazyStore(ClientStateStore):
    """Sharded, lazily materialized client state with LRU spill-to-disk.

    Shard ``s`` owns clients ``[s*shard_size, (s+1)*shard_size)`` as one
    list of host numpy leaves, each client one row.  Lifecycle:

      cold (never written)  --scatter-->  hot (LRU)  --evict-->  spilled
                                             ^                      |
                                             +-------- load --------+

    A gather of a cold client returns the template row and materializes
    nothing; a gather of a spilled client loads its shard into the LRU
    (which may evict another).  The counters (``stats()``) and the spans
    ``store.load``, ``store.materialize`` and ``store.spill`` are the
    reference's."""

    name = "sharded"
    dense = False

    def __init__(self, template: Any, num_clients: int,
                 cfg: StoreConfig | None = None):
        cfg = cfg if cfg is not None else StoreConfig(backend="sharded")
        cfg.validate()
        self.num_clients = num_clients
        self.cfg = cfg
        pairs = items(template)
        self._template = template
        self._paths = [p for p, _ in pairs]
        self._template_leaves = [_host(leaf) for _, leaf in pairs]
        self.device = (pairs[0][1].device
                       if pairs and isinstance(pairs[0][1], torch.Tensor)
                       else torch.device("cpu"))
        self._hot: OrderedDict[int, list[np.ndarray]] = OrderedDict()
        self._spilled: dict[int, str] = {}
        if cfg.spill_dir is None:
            self._dir = tempfile.mkdtemp(prefix="repro_torch_client_store_")
            self._cleanup = weakref.finalize(self, shutil.rmtree, self._dir,
                                             ignore_errors=True)
        else:
            os.makedirs(cfg.spill_dir, exist_ok=True)
            self._dir = cfg.spill_dir
            self._cleanup = None
        self.materializations = 0
        self.spills = 0
        self.loads = 0
        self.cold_gathers = 0
        self.max_hot_seen = 0

    # -- shard plumbing ----------------------------------------------------

    def _sid(self, client: int) -> int:
        return client // self.cfg.shard_size

    def _path(self, sid: int) -> str:
        return os.path.join(self._dir, f"shard_{sid:08d}.msgpack")

    def _touch(self, sid: int) -> list[np.ndarray] | None:
        """A hot shard (LRU-touched) or a spilled one loaded; None: cold."""
        if sid in self._hot:
            self._hot.move_to_end(sid)
            return self._hot[sid]
        if sid in self._spilled:
            # restored leaves view the file's bytes (read-only); a scatter
            # writes rows in place, so those are copied
            with span("store.load", shard=sid):
                leaves = []
                for leaf in ckpt_io.restore(self._spilled[sid]):
                    arr = np.asarray(leaf)
                    leaves.append(arr if arr.flags.writeable else arr.copy())
                self.loads += 1
                self._insert(sid, leaves)
                return leaves
        return None

    def _materialize(self, sid: int) -> list[np.ndarray]:
        """The first write into a cold shard: template rows, writable."""
        with span("store.materialize", shard=sid):
            rows = min(self.cfg.shard_size,
                       self.num_clients - sid * self.cfg.shard_size)
            leaves = [np.repeat(leaf[None], rows, axis=0)
                      for leaf in self._template_leaves]
            self.materializations += 1
            self._insert(sid, leaves)
            return leaves

    def _insert(self, sid: int, leaves: list[np.ndarray]) -> None:
        # evict before inserting, so the hot set never exceeds its cap
        while len(self._hot) >= self.cfg.max_hot_shards:
            old_sid, old_leaves = self._hot.popitem(last=False)
            with span("store.spill", shard=old_sid):
                ckpt_io.save(self._path(old_sid), list(old_leaves),
                             level=self.cfg.spill_level)
            self._spilled[old_sid] = self._path(old_sid)
            self.spills += 1
        self._hot[sid] = leaves
        self._hot.move_to_end(sid)
        self.max_hot_seen = max(self.max_hot_seen, len(self._hot))

    # -- the store contract ------------------------------------------------

    def gather(self, idx) -> Any:
        """The cohort's rows on the device: stacked on the host, one
        host-to-device copy a leaf."""
        rows: list[list[np.ndarray]] = []
        for c in np.asarray(idx):
            c = int(c)
            shard = self._touch(self._sid(c))
            if shard is None:
                self.cold_gathers += 1
                rows.append(self._template_leaves)
            else:
                pos = c - self._sid(c) * self.cfg.shard_size
                rows.append([leaf[pos] for leaf in shard])
        stacked = {p: torch.from_numpy(np.stack([r[j] for r in rows])).to(
                       self.device)
                   for j, p in enumerate(self._paths)}
        return rebuild(self._template, stacked)

    def scatter(self, idx, rows: Any) -> None:
        """The cohort's rows written into their shards: one device-to-host
        copy a leaf."""
        leaves = [_host(leaf) for _, leaf in items(rows)]
        for i, c in enumerate(np.asarray(idx)):
            c = int(c)
            sid = self._sid(c)
            shard = self._touch(sid)
            if shard is None:
                shard = self._materialize(sid)
            pos = c - sid * self.cfg.shard_size
            for j, leaf in enumerate(leaves):
                shard[j][pos] = leaf[i]

    def stats(self) -> dict[str, int]:
        return {"hot_shards": len(self._hot),
                "max_hot_seen": self.max_hot_seen,
                "spilled_shards": len(self._spilled),
                "materializations": self.materializations,
                "spills": self.spills,
                "loads": self.loads,
                "cold_gathers": self.cold_gathers}

    def close(self) -> None:
        self._hot.clear()
        self._spilled.clear()
        if self._cleanup is not None:
            self._cleanup()


STORES: dict[str, type[ClientStateStore]] = {
    "memory": InMemoryStore,
    "sharded": ShardedLazyStore,
}


def make_store(cfg: StoreConfig, template: Any,
               num_clients: int) -> ClientStateStore:
    """A client-state backend from ``EngineConfig.store`` over the
    single-client ``template`` (device tensors)."""
    cfg.validate()
    if cfg.backend == "memory":
        return InMemoryStore(template, num_clients)
    return ShardedLazyStore(template, num_clients, cfg)
