"""Streaming decode-and-accumulate ingest (the server's uplink).

Port of ``repro.fl.ingest.stream``.  The gather path decodes one tree a
cohort member and then averages the list: O(K) server memory and a decode
barrier before any aggregation.  :class:`StreamingIngest` replaces both:
payloads go through a bounded queue into a decode stage (chunks through
``Codec.decode_batch``, optionally on worker threads), and every decoded
contribution folds AT ONCE into three running
:class:`~repro_torch.fl.async_buffer.TreeAccumulator` (params, scales,
BN) and a weight sum.  No more than ``IngestConfig.chunk`` decoded trees
exist at a time (``IngestStats.max_resident``).

Determinism: **fold order is submission order**, whatever ``workers`` or
the chunk boundaries.  Decodes may run concurrently, but their results
fold strictly first in, first out on the caller's thread, so a threaded
ingest is bitwise the inline one, and, the fold being the
``TreeAccumulator`` that ``weighted_mean_trees`` uses over decoded
trees, bitwise the gather path's weighted mean over the same
contributions in the same order.  (The sync plain mean of the gather path
is a float32 ``torch.mean``; the float64 fold equals it for two
contributions and where the float32 sums are exact, and is otherwise
within an ulp of it, as in the reference.)

A payload that raises ``comms.CorruptPayloadError`` is quarantined: its
chunk is decoded again payload by payload, so one bad payload rejects ONE
contribution (a :class:`RejectedPayload`, counter ``ingest.rejected``)
while the rest of the cohort aggregates.

Telemetry (nothing without a registry): ``ingest.decode`` and
``ingest.fold`` spans, the ``ingest.queue_depth`` gauge, the
``ingest.payloads`` and ``ingest.rejected`` counters and the
``ingest.payloads_per_s`` gauge at ``finish``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from repro_torch import comms
from repro_torch.fl.async_buffer import TreeAccumulator
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Knobs of the streaming ingest stage.

    ``chunk`` is the ``decode_batch`` granularity — the ONLY scale factor
    of resident decoded state.  ``queue_depth`` bounds payloads submitted
    but not yet folded; a full queue blocks ``submit`` on the oldest
    decode (backpressure, so a fast producer cannot outrun the decoder
    into unbounded memory).  ``workers=0`` decodes inline on the caller
    thread at chunk boundaries; ``workers>=1`` decodes chunks on a thread
    pool while the caller keeps submitting (results still fold FIFO).
    ``decode_engine`` is forwarded to ``Codec.with_decode_engine`` —
    ``"speculative"`` enables the multi-symbol CABAC decoder and the
    pointer-jump exp-Golomb walk on codecs that support them.
    """
    chunk: int = 8
    queue_depth: int = 32
    workers: int = 0
    decode_engine: str = "vectorized"

    def validate(self) -> None:
        if self.chunk < 1:
            raise ValueError(f"IngestConfig.chunk must be >= 1, "
                             f"got {self.chunk}")
        if self.queue_depth < self.chunk:
            raise ValueError(
                f"IngestConfig.queue_depth ({self.queue_depth}) must be >= "
                f"chunk ({self.chunk}): a queue that cannot hold one chunk "
                "would deadlock the dispatch")
        if self.workers < 0:
            raise ValueError("IngestConfig.workers must be >= 0")


@dataclasses.dataclass(frozen=True)
class RejectedPayload:
    """One quarantined payload: who, how big, and why it failed."""
    seq: int        # submission index within this ingest
    client: int
    nbytes: int
    error: str


@dataclasses.dataclass
class IngestStats:
    payloads: int = 0       # submitted
    accepted: int = 0       # decoded + folded
    rejected: int = 0       # quarantined (CorruptPayloadError)
    bytes: int = 0          # payload bytes submitted
    max_resident: int = 0   # peak decoded-but-not-yet-folded pytrees
    decode_s: float = 0.0   # cumulative decode time (sum over workers)
    fold_s: float = 0.0
    elapsed_s: float = 0.0  # submit->finish wall time

    @property
    def payloads_per_s(self) -> float:
        return self.accepted / self.elapsed_s if self.elapsed_s > 0 else 0.0

    @property
    def mb_per_s(self) -> float:
        return (self.bytes / 1e6 / self.elapsed_s
                if self.elapsed_s > 0 else 0.0)


@dataclasses.dataclass
class IngestResult:
    """The aggregate one ingest produced: weighted means, never lists.

    ``delta_params`` / ``delta_scales`` / ``bn`` are the running weighted
    means over the ACCEPTED contributions (``None`` when no accepted
    payload carried that tree — e.g. ``bn`` under wire schema v1, where BN
    rides out-of-band).  ``weight_sum`` is the accepted weight mass before
    normalisation.
    """
    delta_params: Any
    delta_scales: Any
    bn: Any
    weight_sum: float
    accepted: int
    rejected: list[RejectedPayload]
    stats: IngestStats


class StreamingIngest:
    """One aggregation's decode-and-accumulate pipeline.

    Usage is submit/finish::

        ing = StreamingIngest(codec, spec, IngestConfig(chunk=8), device)
        for client, payload, w in arrivals:
            ing.submit(client, payload, weight=w)
        res = ing.finish()          # -> IngestResult (means + rejects)

    One instance serves ONE aggregation (accumulators are single-use);
    schedulers make a fresh one per aggregation with
    ``FederatedEngine.make_ingest()``.  The sums live on ``device`` (the
    engine's), in float64, as ``TreeAccumulator`` keeps them.
    """

    def __init__(self, codec: comms.Codec, spec: comms.WireSpec,
                 cfg: IngestConfig | None = None, device="cpu"):
        self.cfg = cfg if cfg is not None else IngestConfig()
        self.cfg.validate()
        self.codec = codec.with_decode_engine(self.cfg.decode_engine)
        self.spec = spec
        self._params = TreeAccumulator(device)
        self._scales = TreeAccumulator(device)
        self._bn = TreeAccumulator(device)
        # (seq, client, payload, weight) not yet dispatched to a decode
        self._queue: list[tuple[int, int, bytes, float]] = []
        # FIFO of (future, chunk_len) when workers > 0 — folds drain in
        # submission order no matter which decode finishes first
        self._futures: deque = deque()
        self._ex = (ThreadPoolExecutor(self.cfg.workers)
                    if self.cfg.workers > 0 else None)
        self._seq = 0
        self._resident = 0
        self.rejected: list[RejectedPayload] = []
        self.stats = IngestStats()
        self._t0 = time.perf_counter()
        self._finished = False

    # -- intake ------------------------------------------------------------

    def submit(self, client: int, payload: bytes, weight: float = 1.0) -> None:
        """Queue one payload; may block (backpressure) but never grows
        resident state beyond the queue + one decoded chunk."""
        if self._finished:
            raise RuntimeError("StreamingIngest is single-use: finish() was "
                               "already called")
        self._queue.append((self._seq, int(client), payload, float(weight)))
        self._seq += 1
        self.stats.payloads += 1
        self.stats.bytes += len(payload)
        m = obs_metrics.get_registry()
        if m.enabled:
            m.gauge("ingest.queue_depth", self._pending())
        if len(self._queue) >= self.cfg.chunk:
            self._dispatch()
        # bounded queue: block the producer on the oldest in-flight decode
        # until the backlog is back under queue_depth
        while self._pending() > self.cfg.queue_depth and self._futures:
            self._fold_next()

    def finish(self) -> IngestResult:
        """Drain the queue, fold everything, and return the means."""
        if self._finished:
            raise RuntimeError("finish() already called")
        self._dispatch()
        while self._futures:
            self._fold_next()
        if self._ex is not None:
            self._ex.shutdown()
        self._finished = True
        self.stats.elapsed_s = time.perf_counter() - self._t0
        m = obs_metrics.get_registry()
        if m.enabled:
            m.gauge("ingest.queue_depth", 0)
            m.gauge("ingest.payloads_per_s", self.stats.payloads_per_s)
        return IngestResult(
            delta_params=(self._params.mean() if self._params.count else None),
            delta_scales=(self._scales.mean() if self._scales.count else None),
            bn=self._bn.mean() if self._bn.count else None,
            weight_sum=self._params.weight_sum,
            accepted=self.stats.accepted,
            rejected=list(self.rejected),
            stats=self.stats)

    # -- pipeline internals ------------------------------------------------

    def _pending(self) -> int:
        """Payloads submitted but not yet folded (the queue-depth gauge)."""
        return len(self._queue) + sum(n for _, n in self._futures)

    def _dispatch(self) -> None:
        chunk, self._queue = self._queue, []
        if not chunk:
            return
        if self._ex is None:
            self._fold_chunk(self._decode_chunk(chunk))
        else:
            self._futures.append(
                (self._ex.submit(self._decode_chunk, chunk), len(chunk)))

    def _fold_next(self) -> None:
        fut, _ = self._futures.popleft()
        self._fold_chunk(fut.result())

    def _decode_chunk(self, chunk):
        """Decode one chunk; -> [(seq, client, weight, dec|None, nbytes,
        err|None)].  A corrupt payload poisons only itself: the batch call
        is retried per payload so the typed error attaches to the one
        message that raised it."""
        payloads = [p for _, _, p, _ in chunk]
        t0 = time.perf_counter()
        with obs_trace.span("ingest.decode", n=len(chunk),
                            codec=self.codec.name):
            try:
                decs = self.codec.decode_batch(payloads, self.spec)
                out = [(s, c, w, d, len(p), None)
                       for (s, c, p, w), d in zip(chunk, decs)]
            except comms.CorruptPayloadError:
                out = []
                for s, c, p, w in chunk:
                    try:
                        out.append((s, c, w,
                                    self.codec.decode(p, self.spec),
                                    len(p), None))
                    except comms.CorruptPayloadError as e:
                        out.append((s, c, w, None, len(p),
                                    f"{type(e).__name__}: {e}"))
        self.stats.decode_s += time.perf_counter() - t0
        return out

    def _fold_chunk(self, results) -> None:
        live = sum(1 for r in results if r[3] is not None)
        self._resident += live
        self.stats.max_resident = max(self.stats.max_resident, self._resident)
        m = obs_metrics.get_registry()
        t0 = time.perf_counter()
        with obs_trace.span("ingest.fold", n=len(results)):
            for seq, client, w, dec, nbytes, err in results:
                if dec is None:
                    rej = RejectedPayload(seq=seq, client=client,
                                          nbytes=nbytes, error=err)
                    self.rejected.append(rej)
                    self.stats.rejected += 1
                    if m.enabled:
                        m.count("ingest.rejected", 1)
                    continue
                self._params.add(dec.params, w)
                if dec.scales is not None:
                    self._scales.add(dec.scales, w)
                if dec.bn is not None:
                    self._bn.add(dec.bn, w)
                self.stats.accepted += 1
                self._resident -= 1
        self.stats.fold_s += time.perf_counter() - t0
        if m.enabled:
            m.count("ingest.payloads", len(results))
            m.gauge("ingest.queue_depth", self._pending())
