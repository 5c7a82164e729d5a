"""Virtual-population data views: K cohort rows from C >> base clients.

Port of ``repro.fl.population.virtual``.  ``LocalTrain`` reads client
data through a view with one contract:

    gather(idx) -> (cx, cy, cvx, cvy)   # cohort-stacked rows for idx
    all()       -> the full stacked arrays (dense views only)

:class:`SplitsView` is the identity view over the real splits (on the
device).  :class:`VirtualPopulationView` maps each virtual client id to a
base shard by a hash, ``prand.randint(base, seed, TAG_DATA, id)``, the
reference's map bit for bit, so a virtual client trains on the same base
shard in both packages, in any order it is drawn.  A gather indexes the
device splits once per array with the cohort's base rows.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import prand
from repro_torch.data.federated import FederatedSplits


class SplitsView:
    """Identity data view over the real stacked splits."""

    dense = True

    def __init__(self, splits: FederatedSplits):
        self._splits = splits
        self.num_clients = splits.num_clients
        self.n_train = splits.n_train

    @property
    def client_x(self):
        return self._splits.client_x

    @property
    def client_y(self):
        return self._splits.client_y

    @property
    def client_val_x(self):
        return self._splits.client_val_x

    @property
    def client_val_y(self):
        return self._splits.client_val_y

    @property
    def test_x(self):
        return self._splits.test_x

    @property
    def test_y(self):
        return self._splits.test_y

    def base_index(self, idx) -> np.ndarray:
        return np.asarray(idx)

    def gather(self, idx) -> tuple[Any, Any, Any, Any]:
        s = self._splits
        b = torch.as_tensor(self.base_index(idx).astype(np.int64),
                            device=s.client_x.device)
        return (s.client_x[b], s.client_y[b], s.client_val_x[b],
                s.client_val_y[b])

    def all(self) -> tuple[Any, Any, Any, Any]:
        s = self._splits
        return s.client_x, s.client_y, s.client_val_x, s.client_val_y


class VirtualPopulationView(SplitsView):
    """Hash-mapped view: ``population`` virtual clients over the base
    splits.  ``all()`` is refused: a virtual population exists only
    through cohort gathers."""

    dense = False

    def __init__(self, splits: FederatedSplits, population: int,
                 seed: int = 0):
        super().__init__(splits)
        if population < splits.num_clients:
            raise ValueError(
                f"population ({population}) must be >= the number of base "
                f"data shards ({splits.num_clients}); shrink the splits or "
                "drop the population axis")
        self.num_clients = population
        self.base = splits.num_clients
        self.seed = seed

    def base_index(self, idx) -> np.ndarray:
        """Deterministic virtual-id -> base-shard map (uint64-hash keyed)."""
        return prand.randint(self.base, self.seed, prand.TAG_DATA,
                             np.asarray(idx)).astype(np.int64)

    def all(self):
        raise RuntimeError(
            f"cannot materialize all {self.num_clients} virtual clients; "
            "virtual populations are cohort-gather only")


def make_view(splits: FederatedSplits, population: int | None,
              seed: int = 0) -> SplitsView:
    """Identity view, or a virtual view when a population axis is set."""
    if population is None or population == splits.num_clients:
        return SplitsView(splits)
    return VirtualPopulationView(splits, population, seed)
