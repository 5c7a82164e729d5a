"""Client sampling: which K of C clients participate in a round.

Port of ``repro.fl.sampling``.  Two regimes:

* **materialized** draws, uniform and weighted, over an explicit index
  range, from an explicit ``torch.Generator``, without replacement and
  returned sorted; parity runs pass the reference's draws instead
  (``FederatedEngine(plan=...)``);
* **streaming** draws (:func:`stream_cohort`) over a *virtual* population
  that never exists as an array: candidate ids come from the
  counter-based hash stream ``prand.randint(n, seed, TAG_SAMPLE, round,
  counter)``, filtered by optional weight and acceptance functions and an
  exclusion set.  numpy only: the same arguments give the reference's ids
  exactly.

Also the cohort-row helpers the executors use: ``gather_clients``,
``scatter_clients``, ``pad_clients``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import prand
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """``cohort_size`` None (or >= num_clients) is full participation.
    ``strategy="weighted"`` draws clients in proportion to ``weights``, one
    per client.  ``stream_seed`` seeds the hash-based streaming draws of a
    virtual population or a traffic model (``EngineConfig.population``,
    ``traffic``); the materialized draws ignore it."""
    cohort_size: int | None = None
    strategy: str = "uniform"            # "uniform" | "weighted"
    weights: tuple[float, ...] | None = None
    stream_seed: int = 0                 # streaming (hash-based) draws only

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


def stream_cohort(seed: int, round_idx: int, num_clients: int, k: int, *,
                  weight_fn: Callable[[np.ndarray], np.ndarray] | None = None,
                  accept_fn: Callable[[np.ndarray], np.ndarray] | None = None,
                  exclude=(), strict: bool = True,
                  max_blocks: int = 256) -> np.ndarray:
    """Deterministic hash-based cohort draw over a virtual population.

    Candidates ``prand.randint(num_clients, seed, TAG_SAMPLE, round_idx,
    counter)`` come in vectorized blocks of ``max(4 k, 64)``; the first
    ``k`` distinct accepted ids, sorted, are the cohort, a pure function
    of ``(seed, round_idx)`` and the filters:

    * ``weight_fn(ids) -> p``: weighted sampling by rejection, a candidate
      kept when its coin ``prand.uniform(seed, TAG_WEIGHT, round_idx,
      counter)`` is below ``p`` (relative weights, peak 1);
    * ``accept_fn(ids) -> bool``: availability (a traffic model);
    * ``exclude``: ids never drawn (async in-flight clients).

    ``strict=False`` returns however many ids the draw budget found
    (possibly none) instead of raising: a traffic-gated sync cohort may
    shrink in an availability trough.  ``k >= num_clients`` takes the whole
    range less the exclusions, filtered by ``accept_fn``."""
    if k <= 0:
        return np.empty(0, np.int64)
    if k >= num_clients:
        ids = np.arange(num_clients, dtype=np.int64)
        if exclude:
            ids = ids[~np.isin(ids, np.fromiter(exclude, np.int64,
                                                len(exclude)))]
        if accept_fn is not None:
            ids = ids[np.asarray(accept_fn(ids), bool)]
        return ids
    chosen: list[int] = []
    seen = set(int(c) for c in exclude)
    block = max(4 * k, 64)
    counter = 0
    for _ in range(max_blocks):
        ctr = np.arange(counter, counter + block, dtype=np.int64)
        counter += block
        cand = prand.randint(num_clients, seed, prand.TAG_SAMPLE,
                             round_idx, ctr).astype(np.int64)
        if weight_fn is not None:
            p = np.asarray(weight_fn(cand), np.float64)
            coin = prand.uniform(seed, prand.TAG_WEIGHT, round_idx, ctr)
            cand = cand[coin < p]
        if accept_fn is not None and len(cand):
            cand = cand[np.asarray(accept_fn(cand), bool)]
        for c in cand:
            ci = int(c)
            if ci not in seen:
                seen.add(ci)
                chosen.append(ci)
                if len(chosen) == k:
                    return np.sort(np.asarray(chosen, np.int64))
    if strict:
        raise RuntimeError(
            f"stream_cohort found only {len(chosen)}/{k} acceptable clients "
            f"after {max_blocks * block} draws (population {num_clients}); "
            "availability/weights too thin for the requested cohort")
    return np.sort(np.asarray(chosen, np.int64))


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
