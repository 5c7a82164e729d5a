"""Client sampling: which K of C clients participate in a round.

Port of ``repro.fl.sampling`` (materialized draws, uniform and weighted,
and the cohort-row helpers the executors use: ``gather_clients``,
``scatter_clients``, ``pad_clients``).  Draws come from an explicit
``torch.Generator``, without replacement and returned sorted; parity runs
pass the reference's draws instead (``FederatedEngine(plan=...)``).  The
streaming draw over a virtual population (``stream_cohort``) belongs to
the population item and is not ported.
"""
from __future__ import annotations

import dataclasses

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """``cohort_size`` None (or >= num_clients) is full participation.
    ``strategy="weighted"`` draws clients in proportion to ``weights``, one
    per client."""
    cohort_size: int | None = None
    strategy: str = "uniform"            # "uniform" | "weighted"
    weights: tuple[float, ...] | None = None

    def effective_size(self, num_clients: int) -> int:
        if self.cohort_size is None:
            return num_clients
        return min(self.cohort_size, num_clients)

    def is_full(self, num_clients: int) -> bool:
        return self.effective_size(num_clients) >= num_clients


class EmptyCohortError(RuntimeError):
    """A zero-row cohort reached a stage that needs at least one client."""


def _weighted(gen: torch.Generator, w, k: int) -> np.ndarray:
    """k distinct indices drawn with probabilities ``w / sum(w)``."""
    p = torch.tensor(np.asarray(w, np.float32))
    p = p / torch.sum(p)
    return torch.multinomial(p, k, replacement=False, generator=gen).numpy()


def sample_cohort(gen: torch.Generator, num_clients: int,
                  cfg: SamplingConfig) -> np.ndarray:
    """Sorted client indices for one round (without replacement)."""
    k = cfg.effective_size(num_clients)
    if k >= num_clients:
        return np.arange(num_clients)
    if cfg.strategy == "uniform":
        idx = torch.randperm(num_clients, generator=gen)[:k].numpy()
    elif cfg.strategy == "weighted":
        if cfg.weights is None or len(cfg.weights) != num_clients:
            raise ValueError("weighted sampling needs one weight per client")
        idx = _weighted(gen, cfg.weights, k)
    else:
        raise ValueError(f"unknown sampling strategy: {cfg.strategy!r}")
    return np.sort(idx)


def sample_available(gen: torch.Generator, available: np.ndarray, k: int,
                     cfg: SamplingConfig) -> np.ndarray:
    """k clients of the idle set ``available`` (async replacements: an
    in-flight client cannot be dispatched again until its update lands)."""
    available = np.asarray(available)
    if len(available) <= k:
        return np.sort(available)
    if cfg.strategy == "weighted" and cfg.weights is not None:
        idx = _weighted(gen, [cfg.weights[c] for c in available], k)
    else:
        idx = torch.randperm(len(available), generator=gen)[:k].numpy()
    return np.sort(available[idx])


def _index(idx, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), dtype=torch.long,
                           device=x.device)


def gather_clients(tree: Any, idx: np.ndarray) -> Any:
    """Slice a client-stacked tree down to the cohort rows ``idx``."""
    return tree_map(lambda x: x[_index(idx, x)], tree)


def scatter_clients(full: Any, cohort: Any, idx: np.ndarray) -> Any:
    """The full client-stacked tree with the cohort rows written back at
    ``idx`` (a new tree; ``full`` is not changed)."""
    def put(f, c):
        out = f.clone()
        out[_index(idx, f)] = c.to(f.device)
        return out
    return tree_map(put, full, cohort)


def pad_clients(tree: Any, total: int) -> Any:
    """Pad the leading (client) axis up to ``total`` rows by repeating the
    last row, as the sharded executor pads a ragged cohort to a multiple
    of its mesh (the padded rows are dropped from its output).  A tree at
    or beyond ``total`` rows comes back unchanged; an empty one cannot be
    padded to a positive total and raises :class:`EmptyCohortError`."""
    def pad(x):
        n = x.shape[0]
        if n >= total:
            return x
        if n == 0:
            raise EmptyCohortError(
                f"cannot pad an empty cohort to {total} rows: there is no "
                "client row to repeat (an empty cohort cannot execute)")
        return torch.cat([x, x[-1:].expand((total - n,) + tuple(x.shape[1:]))])
    return tree_map(pad, tree)
