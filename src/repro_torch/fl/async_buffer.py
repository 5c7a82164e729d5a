"""FedBuff-style buffered asynchronous aggregation (Nguyen et al. 2022).

Port of ``repro.fl.async_buffer`` (fixed dispatch windows).  The engine's
async mode keeps M clients training concurrently against whatever server
version each started from.  Finished updates land in a buffer; once B
updates accumulate the server takes one optimizer step on their
*staleness-weighted* mean and its version rises.  Staleness tau is the
number of server versions that elapsed while the client trained; the
FedBuff weight

    w(tau) = 1 / (1 + tau) ** staleness_exponent

is normalised over the buffer, in float64.  Client latencies are lognormal
per client and drive a simulated clock (``RoundRecord.sim_time_s``).

The arrival-adaptive window (``adaptive_window``, sized from the cohort
benchmark's measured per-call saving) belongs to the population item and
is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    buffer_size: int = 4          # B: updates per server step
    concurrency: int = 4          # M: clients training at any moment
    staleness_exponent: float = 0.5
    latency_mean: float = 1.0     # seconds, lognormal median scale
    latency_sigma: float = 0.5    # lognormal shape; 0 = homogeneous clients
    # simulated seconds: in-flight clients finishing within this window of
    # the earliest finisher train in ONE executor call (0.0 = one
    # completion at a time, ties included)
    dispatch_window: float = 0.0
    # the arrival-adaptive window: not ported (EngineConfig.validate
    # raises for it)
    adaptive_window: bool = False


class BufferEntry(NamedTuple):
    client: int
    staleness: int          # server versions elapsed since the client synced
    finish_time: float      # simulated seconds
    delta_params: Any       # reconstructed (dequantized) update
    delta_scales: Any
    bn_state: Any
    up_bytes: int


def client_latencies(gen: torch.Generator, num_clients: int,
                     cfg: AsyncConfig) -> np.ndarray:
    """Per-client simulated round latency (seconds), fixed for the run:
    ``latency_mean * exp(latency_sigma * z)`` with ``z`` standard normal
    from ``gen``."""
    if cfg.latency_sigma == 0.0:
        return np.full(num_clients, cfg.latency_mean, np.float64)
    z = torch.randn(num_clients, generator=gen).numpy()
    return cfg.latency_mean * np.exp(cfg.latency_sigma * z)


def staleness_weight(staleness, exponent: float):
    return 1.0 / (1.0 + np.asarray(staleness, np.float64)) ** exponent


def normalized_staleness_weights(staleness, exponent: float) -> np.ndarray:
    """FedBuff weights over one buffer, normalised to sum to 1."""
    raw = staleness_weight(staleness, exponent)
    return raw / raw.sum()


def _f64(leaf, device) -> torch.Tensor:
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.array(leaf))
    return leaf.to(device=device, dtype=torch.float64)


class TreeAccumulator:
    """Single-pass running weighted mean over a stream of trees.

    Fold order is arrival order: ``add`` number *i* performs ``acc += w_i *
    x_i`` leafwise with the product and the sum in float64; ``mean()``
    divides by ``sum(w_i)`` (a Python float sum, same order) and casts to
    float32 once, at the end.  Leaves may be numpy arrays or tensors; the
    sums live on ``device``."""

    def __init__(self, device="cpu") -> None:
        self.device = torch.device(device)
        self._sum: Any = None
        self._wsum = 0.0
        self.count = 0

    def add(self, tree: Any, weight: float = 1.0) -> None:
        w = float(weight)
        if self.count == 0:
            self._sum = tree_map(lambda l: _f64(l, self.device) * w, tree)
        else:
            def fold(acc, l):
                acc += _f64(l, self.device) * w
                return acc
            self._sum = tree_map(fold, self._sum, tree)
        self._wsum += w
        self.count += 1

    @property
    def weight_sum(self) -> float:
        return self._wsum

    def mean(self, dtype=torch.float32) -> Any:
        """``sum_i(w_i * x_i) / sum_i(w_i)``, cast to ``dtype`` leafwise."""
        if self.count == 0:
            raise ValueError("mean() of an empty TreeAccumulator")
        if self._wsum == 0.0:
            raise ZeroDivisionError("mean() with zero total weight")
        wsum = torch.tensor(self._wsum, dtype=torch.float64,
                            device=self.device)
        return tree_map(lambda l: (l / wsum).to(dtype), self._sum)


def weighted_mean_trees(trees: list[Any], w, *, host: bool,
                        device="cpu") -> Any:
    """Convex combination of trees with per-tree weights ``w``.

    The reference folds a tree by where its leaves live, and the port
    follows the reference's choice, passed as ``host``:

    * ``host=True``, the reference's host numpy trees (decoded payloads):
      :class:`TreeAccumulator` in list order, float64 products and sums,
      one division and one cast to float32, on ``device``;
    * ``host=False``, the reference's device trees (schema v1's BN rows,
      the no-wire path): ``sum(float32(w_i) * l_i)`` in float32, a Python
      sum that starts at 0, on the leaves' device.
    """
    if len(trees) != len(w):
        raise ValueError(f"{len(trees)} trees but {len(w)} weights")
    if host:
        acc = TreeAccumulator(device)
        for wi, t in zip(w, trees):
            acc.add(t, wi)
        return acc.mean()

    def f32_sum(*ls):
        return sum(torch.tensor(np.float32(wi), device=l.device) * l
                   for wi, l in zip(w, ls))

    return tree_map(f32_sum, *trees)


def aggregate_buffer(entries: list[BufferEntry], exponent: float, *,
                     host_bn: bool = True):
    """Staleness-weighted mean of the buffered (decoded) updates ->
    (mean_delta_params, mean_delta_scales, mean_bn, weights), the weights
    normalised to sum to 1.  ``host_bn=False`` folds the BN statistics as
    the reference folds device rows (schema v1)."""
    w = normalized_staleness_weights([e.staleness for e in entries], exponent)
    return (weighted_mean_trees([e.delta_params for e in entries], w,
                                host=True),
            weighted_mean_trees([e.delta_scales for e in entries], w,
                                host=True),
            weighted_mean_trees([e.bn_state for e in entries], w,
                                host=host_bn),
            w)
