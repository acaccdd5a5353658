"""Priced spot markets: seeded rate processes + interruption intensity.

A :class:`SpotMarket` is one capacity pool with a stochastic hourly
rate.  The price path is a mean-reverting (Ornstein-Uhlenbeck style)
walk, precomputed on a fixed grid from one seed so every consumer of
the market — purchase pricing, the savings ledger's billing integral,
the interruption sampler — reads the *identical* path.  Scheduled
price-spike segments (capacity crunches) multiply the walk over
``[t0, t1)`` windows; they are part of the market definition, so a
lookahead shopper can see them coming the way a real spot-placement
advisor surfaces capacity trends.

Interruptions are priced in: the market's interruption intensity is a
function of its *current price relative to base*,

    intensity(t) = interruptions_per_hour * (rate(t)/base_rate)**price_power

so a spike both raises the bill and raises the chance of losing the
instance — the coupling that makes naive cheapest-now shopping lose to
interruption-adjusted shopping (paper follow-up: elastic job scheduling
across cloud offerings).

Interruption *times* are sampled per purchase via Poisson thinning
against the piecewise-constant intensity, from an RNG seeded by
``(exchange seed, purchase index)`` — the same purchase sequence under
the same seed reproduces the same interruption schedule bit-for-bit.

Port of ``repro.market.market``: the same numpy arithmetic and draws,
so a seeded market's prices and interruption times are the reference's
bit for bit.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


class SpotMarket:
    """One spot capacity pool with a seeded hourly-rate process.

    Parameters
    ----------
    base_rate:
        Long-run mean of the price walk ($/hour).
    volatility:
        Per-step shock scale as a fraction of ``base_rate``.
    reversion:
        Mean-reversion strength per step (0 = random walk, 1 = snaps
        back to base every step).
    floor_frac:
        Price floor as a fraction of ``base_rate`` (spot never free).
    spikes:
        ``(t0, t1, mult)`` segments: the walk is multiplied by ``mult``
        for ``t0 <= t < t1`` (scheduled capacity crunches).
    interruptions_per_hour:
        Interruption intensity when the market trades at base price.
    price_power:
        Exponent coupling intensity to price: a market trading at twice
        base interrupts ``2**price_power`` times as often.
    seed / horizon / dt:
        The price path is precomputed over ``[0, horizon]`` on a ``dt``
        grid from ``seed``; beyond ``horizon`` the last price holds.
    """

    def __init__(self, name: str, *, base_rate: float,
                 volatility: float = 0.06, reversion: float = 0.2,
                 floor_frac: float = 0.25,
                 spikes: Sequence[Tuple[float, float, float]] = (),
                 interruptions_per_hour: float = 0.5,
                 price_power: float = 2.0, seed: int = 0,
                 horizon: float = 3600.0, dt: float = 10.0):
        if base_rate <= 0:
            raise ValueError(f"market {name!r}: base_rate must be > 0")
        self.name = name
        self.base_rate = float(base_rate)
        self.interruptions_per_hour = float(interruptions_per_hour)
        self.price_power = float(price_power)
        self.spikes = tuple((float(a), float(b), float(m))
                            for a, b, m in spikes)
        for a, b, _ in self.spikes:
            if b <= a:
                raise ValueError(f"market {name!r}: empty spike [{a}, {b})")
        self.horizon = float(horizon)
        self.dt = float(dt)
        self.seed = seed
        n = max(int(math.ceil(self.horizon / self.dt)), 1) + 1
        rng = np.random.default_rng(seed)
        path = np.empty(n)
        path[0] = self.base_rate
        floor = floor_frac * self.base_rate
        shocks = rng.normal(0.0, volatility * self.base_rate, n - 1)
        for i in range(1, n):
            drift = reversion * (self.base_rate - path[i - 1])
            path[i] = max(path[i - 1] + drift + shocks[i - 1], floor)
        self._path = path

    # ------------------------------------------------------------- price
    def _walk(self, t: float) -> float:
        idx = int(max(t, 0.0) / self.dt)
        return float(self._path[min(idx, len(self._path) - 1)])

    def _spike_mult(self, t: float) -> float:
        m = 1.0
        for a, b, mult in self.spikes:
            if a <= t < b:
                m *= mult
        return m

    def rate(self, t: float) -> float:
        """Instantaneous $/hour at virtual time ``t``."""
        return self._walk(t) * self._spike_mult(t)

    def intensity(self, t: float) -> float:
        """Instantaneous interruption intensity (events/hour) at ``t``."""
        rel = self.rate(t) / self.base_rate
        return self.interruptions_per_hour * rel ** self.price_power

    # ------------------------------------------------------- integration
    def _segments(self, t0: float, t1: float) -> Iterator[
            Tuple[float, float, float]]:
        """Piecewise-constant ``(a, b, rate)`` pieces covering [t0, t1)."""
        if t1 <= t0:
            return
        cuts = {t0, t1}
        k0 = int(math.floor(t0 / self.dt)) + 1
        k1 = int(math.ceil(t1 / self.dt))
        cuts.update(k * self.dt for k in range(k0, k1)
                    if t0 < k * self.dt < t1)
        for a, b, _ in self.spikes:
            for edge in (a, b):
                if t0 < edge < t1:
                    cuts.add(edge)
        pts = sorted(cuts)
        for a, b in zip(pts[:-1], pts[1:]):
            yield a, b, self.rate(0.5 * (a + b))

    def dollars(self, t0: float, t1: float) -> float:
        """Exact cost of holding one instance over ``[t0, t1]``."""
        return sum(r * (b - a) for a, b, r in self._segments(t0, t1)) / 3600.0

    def mean_rate(self, t0: float, window: float) -> float:
        """Average $/hour over ``[t0, t0+window]`` (lookahead pricing)."""
        if window <= 0:
            return self.rate(t0)
        return self.dollars(t0, t0 + window) * 3600.0 / window

    def mean_intensity(self, t0: float, window: float) -> float:
        """Average interruption intensity (events/hour) over the window."""
        if window <= 0:
            return self.intensity(t0)
        acc = 0.0
        for a, b, r in self._segments(t0, t0 + window):
            acc += self.interruptions_per_hour * (
                r / self.base_rate) ** self.price_power * (b - a)
        return acc / window

    # --------------------------------------------------------- sampling
    def sample_interruption(self, t0: float, rng: np.random.Generator,
                            until: Optional[float] = None) -> Optional[float]:
        """First interruption time after ``t0`` (None if none before
        ``until``), via Poisson thinning against ``intensity``.

        The candidate stream depends only on ``rng``, so one purchase =
        one generator = one reproducible interruption draw.
        """
        end = self.horizon if until is None else min(until, self.horizon)
        if end <= t0:
            return None
        lam_max = max((self.interruptions_per_hour
                       * (r / self.base_rate) ** self.price_power
                       for _, _, r in self._segments(t0, end)), default=0.0)
        if lam_max <= 0:
            return None
        t = t0
        for _ in range(100_000):
            t += float(rng.exponential(3600.0 / lam_max))
            if t >= end:
                return None
            if rng.uniform() * lam_max <= self.intensity(t):
                return t
        return None

    def __repr__(self):
        return (f"SpotMarket({self.name!r}, base=${self.base_rate:.2f}/h, "
                f"ir={self.interruptions_per_hour:.2f}/h, "
                f"spikes={len(self.spikes)})")
