"""Channel model: payload bytes -> transfer seconds on the simulated clock.

Port of ``repro.comms.channel`` (numpy only).  A :class:`ChannelModel`
converts every real payload length into an up or down transfer time; a
sync round lasts as long as its slowest participant's ``down + up``.

Every draw is keyed through :mod:`repro_torch.core.prand`: per-client
bandwidth factors hash ``(seed, direction, client)`` and the optional
latency jitter hashes ``(seed, client, round)``, so a client's times do not
depend on which clients were drawn before it.  ``drop_rate`` models upload
loss in sync rounds: a dropped client's upload is charged to the byte
totals (it was sent) but left out of aggregation and of
``RoundRecord.participants``.  Under error feedback (Eq. 5) the engine puts
the dropped client's decoded delta back into its residual, so the lost mass
goes out again in a later round (scale deltas carry no residual and stay
lost).  Drops draw from ``np.random.default_rng((seed, round, client))``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import prand


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Bandwidths in Mbit/s (inf = free transfers), latency in seconds.

    ``latency_sigma > 0`` adds a lognormal jitter to ``latency_s`` drawn
    per ``(client, round)``.
    """
    up_mbps: float = math.inf
    down_mbps: float = math.inf
    latency_s: float = 0.0
    latency_sigma: float = 0.0     # per-(client, round) lognormal jitter
    bandwidth_sigma: float = 0.0   # lognormal per-client spread; 0 = uniform
    drop_rate: float = 0.0         # sync-mode upload loss probability
    seed: int = 0


class ChannelModel:
    def __init__(self, cfg: ChannelConfig, num_clients: int = 0):
        # num_clients is advisory: draws are keyed per client id
        self.cfg = cfg
        self.num_clients = num_clients

    def _bw_factor(self, tag: int, client: int) -> float:
        if self.cfg.bandwidth_sigma <= 0.0:
            return 1.0
        z = float(prand.normal(self.cfg.seed, tag, int(client)))
        return math.exp(self.cfg.bandwidth_sigma * z)

    def _latency(self, client: int, round_idx: int) -> float:
        if self.cfg.latency_sigma <= 0.0 or self.cfg.latency_s == 0.0:
            return self.cfg.latency_s
        z = float(prand.normal(self.cfg.seed, prand.TAG_CHAN_LAT,
                               int(client), int(round_idx)))
        return self.cfg.latency_s * math.exp(self.cfg.latency_sigma * z)

    def up_time(self, client: int, nbytes: int, round_idx: int = 0) -> float:
        """Seconds to upload ``nbytes`` from ``client`` (latency included)."""
        rate = (self.cfg.up_mbps * 1e6 / 8.0
                * self._bw_factor(prand.TAG_BW_UP, client))
        return self._latency(client, round_idx) + (
            0.0 if math.isinf(rate) else nbytes / rate)

    def down_time(self, client: int, nbytes: int,
                  round_idx: int = 0) -> float:
        rate = (self.cfg.down_mbps * 1e6 / 8.0
                * self._bw_factor(prand.TAG_BW_DOWN, client))
        return self._latency(client, round_idx) + (
            0.0 if math.isinf(rate) else nbytes / rate)

    def round_time(self, clients, up_sizes, down_nbytes: int,
                   round_idx: int = 0) -> float:
        """Sync-round duration: the slowest participant's down + up leg."""
        return max((self.down_time(c, down_nbytes, round_idx)
                    + self.up_time(c, n, round_idx)
                    for c, n in zip(clients, up_sizes)), default=0.0)

    def dropped(self, round_idx: int, client: int) -> bool:
        """Deterministic per-(round, client) upload-loss draw."""
        if self.cfg.drop_rate <= 0.0:
            return False
        rng = np.random.default_rng((self.cfg.seed, round_idx, int(client)))
        return bool(rng.random() < self.cfg.drop_rate)
