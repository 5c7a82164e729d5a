"""Client sampling: which K of C clients participate in a round.

Port of ``repro.fl.sampling`` (uniform materialized draws).  Draws come from
an explicit ``torch.Generator``; parity runs pass the reference's cohorts
instead (``FederatedEngine(plan=...)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.runtime import not_ported


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """``cohort_size`` None (or >= num_clients) is full participation."""
    cohort_size: int | None = None
    strategy: str = "uniform"
    weights: tuple[float, ...] | None = None

    def __post_init__(self):
        if self.strategy != "uniform" or self.weights is not None:
            raise not_ported(f"{self.strategy!r} sampling",
                             "sampling and server optimizers")

    def effective_size(self, num_clients: int) -> int:
        if self.cohort_size is None:
            return num_clients
        return min(self.cohort_size, num_clients)

    def is_full(self, num_clients: int) -> bool:
        return self.effective_size(num_clients) >= num_clients


class EmptyCohortError(RuntimeError):
    """A zero-row cohort reached a stage that needs at least one client."""


def sample_cohort(gen: torch.Generator, num_clients: int,
                  cfg: SamplingConfig) -> np.ndarray:
    """Sorted client indices for one round (without replacement)."""
    k = cfg.effective_size(num_clients)
    if k >= num_clients:
        return np.arange(num_clients)
    idx = torch.randperm(num_clients, generator=gen)[:k]
    return np.sort(idx.numpy())
