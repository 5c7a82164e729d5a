"""Counter-based deterministic randomness (splitmix64 finalizer).

A copy of ``repro.core.prand`` (numpy only): the same key gives the same
draw in both packages, bit for bit.

Population-scale simulation cannot afford per-client *state* for its
randomness: a million-client run must reproduce any client's latency draw,
bandwidth factor, device class, or availability coin without ever having
enumerated the population or caring in which order clients materialized.
Everything here is therefore a pure function of an integer key tuple —
``uniform(seed, TAG, client_id, round)`` always returns the same value, on
any host, for any store backend, at any point in the run.

The generator is the splitmix64 finalizer folded over the key parts (the
same construction counter-based PRNGs use).  It is NOT cryptographic and is
not meant to be; it is a simulation-quality hash with good avalanche
behaviour whose draws pass basic uniformity checks.

All functions accept ints and/or one-or-more equal-shaped integer ndarrays
among ``parts`` and vectorize over them.  Tag constants namespace the
streams so e.g. a latency draw can never collide with an availability coin
for the same ``(client, round)``.
"""
from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)

# stream tags (arbitrary distinct constants; never change existing ones —
# they are part of a run's reproducibility contract)
TAG_SAMPLE = 0x51
TAG_WEIGHT = 0x52
TAG_DATA = 0x53
TAG_CLASS = 0x54
TAG_LATENCY = 0x55
TAG_AVAIL = 0x56
TAG_CHURN = 0x57
TAG_CHURN_T = 0x58
TAG_TZ = 0x59
TAG_BW_UP = 0x5A
TAG_BW_DOWN = 0x5B
TAG_CHAN_LAT = 0x5C


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer; input/output uint64 ndarray (wraps mod 2^64)."""
    z = x + _GOLDEN
    z = (z ^ (z >> np.uint64(30))) * _MIX1
    z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def fold(*parts) -> np.ndarray:
    """Hash a key tuple into uint64; ndarray parts broadcast elementwise.

    Always returns an ndarray (0-d for all-scalar keys) so numpy's silent
    array wraparound semantics apply — scalar uint64 overflow would warn.
    """
    h = np.zeros((), np.uint64)
    # uint64 wraparound is the hash working as designed, not an error —
    # numpy 2 warns on 0-d (scalar-like) overflow unless told otherwise
    with np.errstate(over="ignore"):
        for p in parts:
            arr = np.asarray(p)
            if arr.dtype.kind not in "iu":
                raise TypeError(f"prand key parts must be integers, got "
                                f"{arr.dtype} for {p!r}")
            h = _mix64(np.bitwise_xor(h, arr.astype(np.uint64)))
    return h


def uniform(*parts):
    """Deterministic u64 -> float64 in [0, 1) for the key tuple."""
    return (fold(*parts) >> np.uint64(11)) * (2.0 ** -53)


def normal(*parts):
    """Standard-normal draw per key tuple (Box-Muller over two substreams)."""
    u1 = np.maximum(uniform(*parts, 0), 2.0 ** -53)  # log(0) guard
    u2 = uniform(*parts, 1)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


def randint(n: int, *parts):
    """Deterministic draw in [0, n) per key tuple (modulo; bias is
    O(n / 2^64), negligible for any population size)."""
    if n <= 0:
        raise ValueError(f"randint needs n > 0, got {n}")
    return fold(*parts) % np.uint64(n)
