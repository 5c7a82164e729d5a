"""Typed metrics: counters, gauges and histograms with per-round snapshots.

Port of ``repro.obs.metrics`` (pure Python, unchanged but for this note).
The registry is the numbers half of the telemetry layer (spans are the
*when*, metrics the *how much*): uplink and downlink bytes per codec
section, per-layer update sparsity and Eq. 5 residual norms, pool task
counts, dispatch-window fill, simulated against wall clock.

Three instruments, thread-safe behind one registry lock (pooled uplink
workers count section bytes concurrently):

* **Counter** (``count``): a monotonic sum.  A round snapshot reports the
  DELTA since the previous snapshot and the running total, so
  ``rec.telemetry["counters"]["uplink.bytes"]`` equals that round's
  ``RoundRecord.up_bytes`` exactly.
* **Gauge** (``gauge``): the last value written.
* **Histogram** (``observe``): count, sum, min and max of the
  observations since the previous snapshot; no samples are kept.

Instrumented modules call the module-level ``count``, ``gauge`` and
``observe``, which forward to the active registry (default
:data:`NOOP_METRICS`, whose helpers return at once).  The active registry
is a plain module global: thread-pool workers see it, forkserver workers
do not (their totals are counted in the parent).

Metrics only read simulation values, so records are bitwise the same with
telemetry on or off.
"""
from __future__ import annotations

import json
import threading
from typing import Any

__all__ = [
    "MetricsRegistry", "NoopMetrics", "NOOP_METRICS",
    "get_registry", "use_registry", "count", "gauge", "observe",
]


class _Hist:
    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def summary(self) -> dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0}
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "mean": self.sum / self.count}


class NoopMetrics:
    """The telemetry-off registry: every helper returns immediately."""

    enabled = False

    def count(self, name: str, v: float = 1) -> None:
        pass

    def gauge(self, name: str, v: float) -> None:
        pass

    def observe(self, name: str, v: float) -> None:
        pass

    def snapshot_round(self) -> None:
        return None


NOOP_METRICS = NoopMetrics()


class MetricsRegistry:
    """Thread-safe counters/gauges/histograms with per-round snapshotting."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._last: dict[str, float] = {}     # counter totals at last snapshot
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Hist] = {}

    # -- instruments -------------------------------------------------------

    def count(self, name: str, v: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + v

    def gauge(self, name: str, v: float) -> None:
        with self._lock:
            self._gauges[name] = v

    def observe(self, name: str, v: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Hist()
            h.observe(v)

    # -- snapshots ---------------------------------------------------------

    def snapshot_round(self) -> dict[str, Any]:
        """Close one round: counter deltas since the previous snapshot (plus
        running totals), current gauges, and the round's histogram
        summaries.  Histograms reset; counters keep accumulating."""
        with self._lock:
            deltas = {k: v - self._last.get(k, 0)
                      for k, v in self._counters.items()}
            snap = {
                "counters": deltas,
                "counters_total": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary()
                               for k, h in self._hists.items()},
            }
            self._last = dict(self._counters)
            self._hists.clear()
            return snap


# ---------------------------------------------------------------- ambient

_active: MetricsRegistry | NoopMetrics = NOOP_METRICS


def get_registry() -> MetricsRegistry | NoopMetrics:
    return _active


class _UseRegistry:
    def __init__(self, reg: MetricsRegistry | NoopMetrics):
        self._reg = reg

    def __enter__(self):
        global _active
        self._prev = _active
        _active = self._reg
        return self._reg

    def __exit__(self, *exc) -> None:
        global _active
        _active = self._prev


def use_registry(reg: MetricsRegistry | NoopMetrics) -> _UseRegistry:
    return _UseRegistry(reg)


def count(name: str, v: float = 1) -> None:
    if _active is not NOOP_METRICS:
        _active.count(name, v)


def gauge(name: str, v: float) -> None:
    if _active is not NOOP_METRICS:
        _active.gauge(name, v)


def observe(name: str, v: float) -> None:
    if _active is not NOOP_METRICS:
        _active.observe(name, v)


# ---------------------------------------------------------------- sink

class MetricsJsonlSink:
    """One JSON line a round snapshot, ``{"round": r, **snapshot}``: the
    long-run stream (``EngineConfig.metrics_out``).  The file opens at the
    first write, so a bundle with a sink path costs nothing until a round
    snapshots."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def write(self, round_idx: int, snap: dict[str, Any]) -> None:
        if self._f is None:
            self._f = open(self.path, "w")
        self._f.write(json.dumps({"round": round_idx, **snap}) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
