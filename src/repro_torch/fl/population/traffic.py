"""Trace-driven client traffic: who is reachable, how fast, who churns.

Port of ``repro.fl.population.traffic`` (numpy and ``prand`` only: the
same configuration gives the same draws in both packages).

Cross-device FL populations are not a flat pool of identical always-on
workers: availability follows diurnal load curves (devices charge and idle
overnight *in their own timezone*), compute speed follows a device-class
mix, and clients churn mid-round (backgrounded app, lost network).  The
:class:`TrafficModel` turns a :class:`TrafficConfig` trace into the three
per-client signals the schedulers consume:

  * ``available(ids, now, round)`` — Bernoulli availability per client,
    probability read off the diurnal curve at the client's *local* time
    (per-client timezone offset), used as the acceptance filter of the
    streaming cohort sampler,
  * ``latency(client)`` — simulated compute seconds per round: the class
    speed of the client's hashed device class times a per-client lognormal
    factor,
  * ``churned(client, dispatch)`` / ``churn_time(...)`` — whether (and at
    what fraction of its round) a dispatched client aborts before
    uploading.

Everything is a pure function of ``(cfg.seed, client_id, round/dispatch)``
through :mod:`repro_torch.core.prand`, so a streamed client re-materialized
from a cold store reproduces exactly the draws it would have had resident —
O(1) memory in the population, by construction.

The model composes with :class:`repro_torch.comms.ChannelModel`, which owns
the bytes->seconds wire legs: traffic decides *when a client can run and
how long it computes*; the channel decides *how long its payload flies*.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import prand

#: Relative availability over 24 local hours: overnight trough, evening
#: peak — the canonical shape of consumer-device FL traffic traces.
DIURNAL_DEFAULT: tuple[float, ...] = (
    0.25, 0.20, 0.15, 0.15, 0.20, 0.30, 0.45, 0.60,
    0.70, 0.75, 0.80, 0.85, 0.90, 0.90, 0.85, 0.80,
    0.80, 0.85, 0.95, 1.00, 0.90, 0.70, 0.50, 0.35)


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """One tier of the device mix; ``speed`` divides the base latency."""
    name: str
    fraction: float
    speed: float = 1.0


#: High/mid/low-end mix loosely matching published cross-device fleets.
DEVICE_MIX_DEFAULT: tuple[DeviceClass, ...] = (
    DeviceClass("hi", 0.2, 2.0),
    DeviceClass("mid", 0.5, 1.0),
    DeviceClass("lo", 0.3, 0.5))


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Scenario axis: arrival/availability trace for the population.

    ``diurnal`` is a cyclic trace of relative availability samples over one
    ``day_s``-second period (linearly interpolated, wrapped); ``None``
    means flat traffic.  ``availability`` scales the whole curve (peak
    acceptance probability).  ``timezone_spread`` phase-shifts each
    client's local time by up to that fraction of a day (hashed per
    client), so a global population's troughs overlap instead of
    synchronizing.  ``churn_rate`` is the per-dispatch probability a
    client aborts mid-round before uploading.
    """
    diurnal: tuple[float, ...] | None = None
    day_s: float = 86400.0
    availability: float = 1.0
    timezone_spread: float = 0.0        # fraction of a day, [0, 1]
    classes: tuple[DeviceClass, ...] = DEVICE_MIX_DEFAULT
    latency_mean: float = 1.0           # seconds of client compute per round
    latency_sigma: float = 0.4          # per-client lognormal spread
    churn_rate: float = 0.0
    seed: int = 0

    def validate(self) -> None:
        if self.diurnal is not None:
            if len(self.diurnal) < 2:
                raise ValueError("diurnal trace needs >= 2 samples")
            if min(self.diurnal) < 0.0 or max(self.diurnal) <= 0.0:
                raise ValueError("diurnal trace must be non-negative with a "
                                 "positive peak")
        if self.day_s <= 0.0:
            raise ValueError("day_s must be > 0")
        if not 0.0 < self.availability <= 1.0:
            raise ValueError("availability must be in (0, 1]")
        if not 0.0 <= self.timezone_spread <= 1.0:
            raise ValueError("timezone_spread is a fraction of a day")
        total = sum(c.fraction for c in self.classes)
        if not self.classes or abs(total - 1.0) > 1e-6:
            raise ValueError(f"device-class fractions must sum to 1, "
                             f"got {total}")
        if any(c.speed <= 0.0 for c in self.classes):
            raise ValueError("device-class speeds must be > 0")
        if not 0.0 <= self.churn_rate <= 1.0:
            # 1.0 (no client ever uploads) is legal: the schedulers bound
            # their retry loops and surface all-drop rounds instead of
            # spinning, so even total churn terminates
            raise ValueError("churn_rate must be in [0, 1]")
        if self.latency_mean <= 0.0 or self.latency_sigma < 0.0:
            raise ValueError("latency_mean must be > 0 and latency_sigma "
                             ">= 0")


class TrafficModel:
    """Deterministic per-client traffic signals for the schedulers."""

    def __init__(self, cfg: TrafficConfig):
        cfg.validate()
        self.cfg = cfg
        self._speeds = np.asarray([c.speed for c in cfg.classes], np.float64)
        self._cum = np.cumsum([c.fraction for c in cfg.classes])
        if cfg.diurnal is not None:
            curve = np.asarray(cfg.diurnal, np.float64)
            self._curve = curve / curve.max()
        else:
            self._curve = None

    # -- device classes ----------------------------------------------------

    def device_class(self, ids) -> np.ndarray:
        """Class index per client (hashed assignment matching fractions)."""
        u = prand.uniform(self.cfg.seed, prand.TAG_CLASS, np.asarray(ids))
        return np.minimum(np.searchsorted(self._cum, u, side="right"),
                          len(self._cum) - 1)

    # -- compute latency ---------------------------------------------------

    def latency(self, client: int) -> float:
        """Simulated compute seconds for one round on ``client``."""
        speed = self._speeds[self.device_class(np.asarray([client]))[0]]
        z = float(prand.normal(self.cfg.seed, prand.TAG_LATENCY, client))
        return float(self.cfg.latency_mean / speed
                     * np.exp(self.cfg.latency_sigma * z))

    # -- availability ------------------------------------------------------

    def rate(self, now: float, ids=None) -> np.ndarray | float:
        """Availability probability at sim time ``now`` (per client when
        ``ids`` given: the diurnal curve is read at each client's local
        time, offset by its hashed timezone)."""
        if self._curve is None:
            base = np.float64(self.cfg.availability)
            return base if ids is None else np.full(len(ids), base)
        t = np.asarray(now, np.float64)
        if ids is not None and self.cfg.timezone_spread > 0.0:
            tz = prand.uniform(self.cfg.seed, prand.TAG_TZ, np.asarray(ids))
            t = t + tz * self.cfg.timezone_spread * self.cfg.day_s
        phase = (t % self.cfg.day_s) / self.cfg.day_s * len(self._curve)
        lo = np.floor(phase).astype(int) % len(self._curve)
        hi = (lo + 1) % len(self._curve)
        frac = phase - np.floor(phase)
        val = self._curve[lo] * (1.0 - frac) + self._curve[hi] * frac
        out = self.cfg.availability * val
        return out if ids is not None else float(out)

    def available(self, ids, now: float, round_idx: int) -> np.ndarray:
        """Bernoulli availability per client, keyed ``(client, round)`` —
        re-querying the same client in the same round repeats the draw."""
        ids = np.asarray(ids)
        p = self.rate(now, ids)
        coin = prand.uniform(self.cfg.seed, prand.TAG_AVAIL, round_idx, ids)
        return coin < p

    # -- churn -------------------------------------------------------------

    def churned(self, client: int, dispatch: int) -> bool:
        """Does this dispatch abort mid-round (before uploading)?"""
        if self.cfg.churn_rate <= 0.0:
            return False
        u = prand.uniform(self.cfg.seed, prand.TAG_CHURN, client, dispatch)
        return bool(u < self.cfg.churn_rate)

    def churn_time(self, client: int, dispatch: int) -> float:
        """Fraction of the client's round completed before it churns."""
        return float(prand.uniform(self.cfg.seed, prand.TAG_CHURN_T,
                                   client, dispatch))


#: Named presets for the reference example's ``--traffic``.
TRAFFIC_PRESETS: dict[str, TrafficConfig] = {
    "flat": TrafficConfig(),
    "diurnal": TrafficConfig(diurnal=DIURNAL_DEFAULT, day_s=240.0,
                             timezone_spread=0.25, latency_mean=4.0),
    "churn": TrafficConfig(churn_rate=0.2, latency_mean=2.0),
}
