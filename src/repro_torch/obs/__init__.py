"""Round-lifecycle telemetry: span tracing and typed metrics, one bundle.

Port of ``repro.obs``.  ``obs.trace`` records *when* each stage ran (spans,
exported to JSONL or Chrome trace-event JSON for Perfetto) and
``obs.metrics`` *how much* it moved (counters, gauges, histograms,
snapshotted per round into ``RoundRecord.telemetry``).  The engine owns
one :class:`Telemetry` bundle:

    tel = make_telemetry("trace")            # "off" | "metrics" | "trace"
    with tel.activate():                     # ambient for the whole run
        ... instrumented code calls trace.span() / metrics.count() ...
        snap = tel.round_snapshot(round_idx)  # None when mode="off"
    tel.export_chrome_trace("run.trace.json")

Modes: ``"off"``, the shared no-op bundle (nothing recorded, nothing
allocated); ``"metrics"``, the registry records and spans stay no-ops;
``"trace"``, spans and metrics.  Telemetry never feeds back into the
simulation, so records are bitwise the same with it on or off.
"""
from __future__ import annotations

from typing import Any

from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import (MetricsRegistry, NOOP_METRICS,
                                     NoopMetrics)
from repro_torch.obs.trace import (NOOP, NoopRecorder, Span, SpanRecorder,
                                   export_chrome_trace, export_jsonl)

__all__ = [
    "trace", "metrics",
    "Telemetry", "make_telemetry", "TELEMETRY_MODES",
    "Span", "SpanRecorder", "NoopRecorder", "NOOP",
    "MetricsRegistry", "NoopMetrics", "NOOP_METRICS",
    "export_chrome_trace", "export_jsonl",
]

TELEMETRY_MODES = ("off", "metrics", "trace")


class _Activation:
    """Activate recorder + registry together; restores both on exit."""

    def __init__(self, tel: "Telemetry"):
        self._tel = tel

    def __enter__(self) -> "Telemetry":
        self._rec = trace.use_recorder(self._tel.recorder)
        self._reg = metrics.use_registry(self._tel.metrics)
        self._rec.__enter__()
        self._reg.__enter__()
        return self._tel

    def __exit__(self, *exc) -> None:
        self._reg.__exit__(*exc)
        self._rec.__exit__(*exc)


class Telemetry:
    """One run's telemetry: a recorder and a registry.

    ``round_snapshot`` is what the engine calls once per aggregation: it
    closes the metrics round (counter deltas, gauge values, histogram
    summaries) and remembers the wall-clock position so Chrome counter tracks line
    up with the span timeline.
    """

    def __init__(self, mode: str = "off", *, ring: int = trace.DEFAULT_RING):
        if mode not in TELEMETRY_MODES:
            known = ", ".join(TELEMETRY_MODES)
            raise ValueError(f"unknown telemetry mode: {mode!r} "
                             f"(known: {known})")
        self.mode = mode
        self.recorder = trace.SpanRecorder(ring) if mode == "trace" else NOOP
        self.metrics = (MetricsRegistry() if mode in ("metrics", "trace")
                        else NOOP_METRICS)
        self._counter_marks: list[dict[str, Any]] = []

    @property
    def on(self) -> bool:
        return self.mode != "off"

    def activate(self) -> _Activation:
        return _Activation(self)

    def round_snapshot(self, round_idx: int) -> dict[str, Any] | None:
        if not self.on:
            return None
        snap = self.metrics.snapshot_round()
        if self.mode == "trace":
            import time
            self._counter_marks.append({
                "ts_ns": time.perf_counter_ns(),
                "round": round_idx,
                "counters": snap["counters"],
            })
        return snap

    # -- exports -----------------------------------------------------------

    def _counter_events(self) -> list[dict[str, Any]]:
        """Per-round byte counters as Chrome "C" events (Perfetto tracks)."""
        events = []
        for mark in self._counter_marks:
            for name in ("uplink.bytes", "downlink.bytes"):
                if name in mark["counters"]:
                    events.append({"name": name, "ts_ns": mark["ts_ns"],
                                   "values": {"bytes":
                                              mark["counters"][name]}})
        return events

    def export_chrome_trace(self, path: str) -> int:
        """Write the recorded spans (+ per-round counters) as Chrome
        trace-event JSON; returns the event count (0 when mode != trace)."""
        if self.recorder is NOOP:
            return 0
        return export_chrome_trace(self.recorder.snapshot(), path,
                                   counters=self._counter_events())

    def export_jsonl(self, path: str) -> int:
        if self.recorder is NOOP:
            return 0
        return export_jsonl(self.recorder.snapshot(), path)


_OFF = Telemetry("off")


def make_telemetry(mode: str = "off", *,
                   ring: int = trace.DEFAULT_RING) -> Telemetry:
    """Build a bundle; ``"off"`` returns the shared no-op singleton."""
    if mode == "off":
        return _OFF
    return Telemetry(mode, ring=ring)
