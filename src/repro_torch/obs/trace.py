"""Span tracing: monotonic, ring-buffered, thread-safe, Perfetto-ready.

Port of ``repro.obs.trace``.  A span is ONE completed interval ``(name,
t0_ns, dur_ns, thread, attrs)`` appended to a lock-protected ring buffer
at ``__exit__``; ``time.perf_counter_ns`` gives one monotonic clock for
every thread, so pooled uplink workers land on one timeline, and the ring
bound keeps a long run's memory flat.

Instrumented code (the ``fl.rounds`` stages, the codecs, the CABAC coder,
the ingest) calls the module-level :func:`span`, which forwards to the
process-wide active recorder.  The default is :data:`NOOP`, whose spans
are one shared no-op context manager: telemetry off records nothing and
allocates nothing.  The active recorder is a plain module global (not a
contextvar), so thread-pool workers inherit it; forkserver workers live
in another process and never see it.

Device bridging: the port has no compiled programs to name, so the
device side is ``torch.profiler``.  While a profiler session records,
every span is also a ``torch.profiler.record_function`` annotation, so
the coder's and stages' host intervals appear in its timeline and
``key_averages()`` (one span function: :data:`device_span`, the
reference's name for a span on the device timeline, is the same one).

Exporters: :func:`export_jsonl` writes one JSON object per span per line;
:func:`export_chrome_trace` writes Chrome trace-event JSON ("X" complete
events, microsecond timestamps) that Perfetto and ``chrome://tracing``
open directly.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any

import torch

__all__ = [
    "Span", "SpanRecorder", "NoopRecorder", "NOOP",
    "get_recorder", "use_recorder", "span", "device_span", "device_trace",
    "export_jsonl", "export_chrome_trace",
]

DEFAULT_RING = 65536


class Span:
    """One completed interval.  ``t0_ns`` is ``perf_counter_ns`` at entry;
    ``attrs`` is the keyword metadata the call site attached."""

    __slots__ = ("name", "t0_ns", "dur_ns", "thread", "attrs")

    def __init__(self, name: str, t0_ns: int, dur_ns: int, thread: int,
                 attrs: dict[str, Any] | None):
        self.name = name
        self.t0_ns = t0_ns
        self.dur_ns = dur_ns
        self.thread = thread
        self.attrs = attrs

    def as_dict(self) -> dict[str, Any]:
        d = {"name": self.name, "t0_ns": self.t0_ns, "dur_ns": self.dur_ns,
             "thread": self.thread}
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"Span({self.name!r}, {self.dur_ns / 1e6:.3f} ms, "
                f"thread={self.thread})")


class _ActiveSpan:
    """The context manager one ``recorder.span()`` call returns.

    Records at ``__exit__`` — children therefore land in the buffer BEFORE
    their parent, which exporters and tests rely on (a parent's interval
    strictly contains its children's)."""

    __slots__ = ("_rec", "name", "attrs", "_t0")

    def __init__(self, rec: "SpanRecorder", name: str,
                 attrs: dict[str, Any] | None):
        self._rec = rec
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_ActiveSpan":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        self._rec._record(Span(self.name, self._t0, t1 - self._t0,
                               threading.get_ident(), self.attrs))


class _NoopSpan:
    """Shared, reusable no-op span (the telemetry-off fast path)."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class NoopRecorder:
    """Records nothing; every ``span()`` returns the one shared no-op."""

    enabled = False

    def span(self, name: str, **attrs) -> _NoopSpan:
        return _NOOP_SPAN

    def drain(self) -> list[Span]:
        return []

    def __len__(self) -> int:
        return 0


NOOP = NoopRecorder()


class SpanRecorder:
    """Thread-safe ring buffer of completed spans.

    ``ring`` bounds memory: when full, the oldest spans drop (a long run
    keeps its recent history).  ``dropped`` counts what the ring evicted so
    exporters can say the trace is a suffix, not the whole run.
    """

    enabled = True

    def __init__(self, ring: int = DEFAULT_RING):
        if ring < 1:
            raise ValueError(f"ring must be >= 1, got {ring}")
        self._buf: deque[Span] = deque(maxlen=ring)
        self._lock = threading.Lock()
        self.dropped = 0

    def span(self, name: str, **attrs) -> _ActiveSpan:
        return _ActiveSpan(self, name, attrs or None)

    def _record(self, s: Span) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(s)

    def drain(self) -> list[Span]:
        """Snapshot AND clear the buffer (completion order: children before
        parents; sort by ``t0_ns`` for a timeline)."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out

    def snapshot(self) -> list[Span]:
        """Non-destructive copy of the buffer."""
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


# ---------------------------------------------------------------- ambient

_active: SpanRecorder | NoopRecorder = NOOP


def get_recorder() -> SpanRecorder | NoopRecorder:
    return _active


class _UseRecorder:
    """Push/pop the ambient recorder (re-entrant; restores the previous)."""

    def __init__(self, rec: SpanRecorder | NoopRecorder):
        self._rec = rec

    def __enter__(self):
        global _active
        self._prev = _active
        _active = self._rec
        return self._rec

    def __exit__(self, *exc) -> None:
        global _active
        _active = self._prev


def use_recorder(rec: SpanRecorder | NoopRecorder) -> _UseRecorder:
    return _UseRecorder(rec)


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording on this thread's
    process (read without importing anything)."""
    return torch.autograd._profiler_enabled()


class _ProfiledSpan:
    """A host span (or none) inside ``torch.profiler.record_function``, so
    the interval lands on the profiler's timeline, host and device, and in
    its ``key_averages()``."""

    __slots__ = ("_span", "_ann")

    def __init__(self, host_span, name: str):
        self._span = host_span
        self._ann = torch.profiler.record_function(name)

    def __enter__(self):
        self._span.__enter__()
        self._ann.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._ann.__exit__(*exc)
        self._span.__exit__(*exc)


def span(name: str, **attrs):
    """Open a span on the ambient recorder; while a ``torch.profiler``
    session records, the span is also a ``record_function`` annotation
    (the port's one span: nothing else marks host intervals).  With no
    recorder and no profiler it is the shared no-op: nothing is recorded
    and nothing allocated."""
    if _active is NOOP:
        if not _profiling():
            return _NOOP_SPAN
        return _ProfiledSpan(_NOOP_SPAN, name)
    host = _active.span(name, **attrs)
    return _ProfiledSpan(host, name) if _profiling() else host


# The reference's span that also marks the device timeline: ``span``
# already does, as a ``record_function`` while a profiler records.
device_span = span


# ------------------------------------------------------------ device trace

_SENTINEL = "spin_kernel"     # the kernel of ``torch.cuda._sleep``
_PAD_S = 0.5                  # host seconds inside each end of a session


def device_trace(fn, tries: int = 10, need_all: bool = True):
    """``fn()``'s device operations on the card from a ``torch.profiler``
    session -> ``(rows, wall_ms, attempt, whole)``: the CUDA rows of
    ``key_averages()`` (no user annotations), ``fn``'s host wall ms, which
    attempt gave them, and whether the session kept every record.

    After long stretches of device work the profiler (torch 2.11, CUDA
    12.8, on an H100) drops device records, counting them "out of range"
    of its capture window: some of a long session's, often all of a short
    one's.  So ``fn`` runs between two spin kernels
    (``torch.cuda._sleep``), half a second of host time inside each end
    of the session.  A session that kept both spin kernels is whole; one that
    lost either is taken again, up to ``tries`` times.  Then it raises,
    unless ``need_all`` is false and some session kept records of
    ``fn``: the last such is returned with ``whole`` false.  A reading
    never goes missing unseen."""
    from torch.profiler import ProfilerActivity, profile
    last = None
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(_PAD_S)
            torch.cuda._sleep(1000)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(_PAD_S)
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        spins = sum(e.count for e in rows if _SENTINEL in e.key)
        rows = [e for e in rows if _SENTINEL not in e.key]
        if spins == 2:
            return rows, wall_ms, attempt, True
        if rows:
            last = (rows, wall_ms, attempt, False)
    if last is not None and not need_all:
        return last
    raise RuntimeError(
        f"torch.profiler dropped device records in {tries} sessions in a "
        f"row (a {wall_ms:.1f} ms call)")


# ---------------------------------------------------------------- exporters

def export_jsonl(spans: list[Span], path: str) -> int:
    """One JSON object per span per line (timeline order); returns count."""
    ordered = sorted(spans, key=lambda s: s.t0_ns)
    with open(path, "w") as f:
        for s in ordered:
            f.write(json.dumps(s.as_dict()) + "\n")
    return len(ordered)


def chrome_trace_events(spans: list[Span], *,
                        counters: list[dict[str, Any]] | None = None,
                        pid: int | None = None) -> list[dict[str, Any]]:
    """Spans -> Chrome trace-event dicts ("X" complete events, ts/dur µs).

    Timestamps rebase to the earliest span so the trace opens at t=0;
    thread ids remap to small consecutive integers (Perfetto track names
    stay readable).  ``counters`` optionally appends "C" counter events —
    ``{"name": ..., "ts_ns": ..., "values": {series: number}}`` — which
    Perfetto renders as per-round counter tracks.
    """
    pid = pid if pid is not None else os.getpid()
    ordered = sorted(spans, key=lambda s: s.t0_ns)
    t_base = ordered[0].t0_ns if ordered else 0
    tids: dict[int, int] = {}
    events: list[dict[str, Any]] = []
    for s in ordered:
        tid = tids.setdefault(s.thread, len(tids))
        ev = {"name": s.name, "ph": "X", "pid": pid, "tid": tid,
              "ts": (s.t0_ns - t_base) / 1e3, "dur": s.dur_ns / 1e3}
        if s.attrs:
            ev["args"] = s.attrs
        events.append(ev)
    for c in counters or []:
        events.append({"name": c["name"], "ph": "C", "pid": pid, "tid": 0,
                       "ts": max(0.0, (c["ts_ns"] - t_base) / 1e3),
                       "args": c["values"]})
    return events


def export_chrome_trace(spans: list[Span], path: str, *,
                        counters: list[dict[str, Any]] | None = None) -> int:
    """Write Chrome trace-event JSON (open at https://ui.perfetto.dev).

    Returns the number of events written.  The file is the object form
    (``{"traceEvents": [...]}``) — both Perfetto and chrome://tracing
    accept it, and it leaves room for metadata.
    """
    events = chrome_trace_events(spans, counters=counters)
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
        f.write("\n")
    return len(events)
