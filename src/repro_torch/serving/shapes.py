"""Behaviour-shaped arrival processes: the million-request load library.

Port of ``repro.serving.shapes``: the same seeded numpy streams.

Every generator is a seeded, time-ordered ``ArrivalProcess`` producing a
**nonhomogeneous Poisson** stream at a time-varying rate ``rate(t)`` via
Lewis-Shedler thinning: candidate gaps are drawn at the envelope rate
``rate_max`` and each candidate survives with probability
``rate(t) / rate_max``.  Requests are built lazily, one per *accepted*
arrival — a 10^6-request diurnal trace never materializes a request
list (``PoissonArrivals`` copies every ``Request`` up front; these
stream), and same seed → bit-identical ``(t, rid)`` streams.

The shape catalogue ports the Kube-DRM behaviour library
(``scripts_behaviour/``: pulse_spikes, sawtooth, staircase, epochs,
staged_plateau — "Kub: Enabling Elastic HPC Workloads on Containerized
Environments", arXiv:2410.10655) plus a smooth ``diurnal`` day/night
cycle, the load family the elastic-job-scheduler evaluation matrix runs
under ("An Elastic Job Scheduler for HPC Applications on the Cloud",
arXiv:2510.15147).

Each shape also exposes ``segments(until)`` — ``(start, end,
mean_rate)`` windows of its rate profile — so property tests can hold
the empirical per-segment rate against the nominal one, and
``make_shape(name, n, rate=...)`` parameterizes any catalogue shape
around a target long-run mean rate (what the matrix benchmark scales to
fleet capacity).
"""

from __future__ import annotations

import math
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.serving.engine import Request
from repro_torch.serving.workload import (BATCH, INTERACTIVE,
                                          ArrivalProcess, SLOClass)


class ShapedArrivals(ArrivalProcess):
    """Base: seeded nonhomogeneous Poisson by thinning, lazy requests.

    Subclasses define the rate profile: ``rate(t)`` (instantaneous
    requests/virtual-second), ``rate_max`` (a tight upper envelope — the
    thinning proposal rate), and ``segments(until)``.  Request shapes
    mirror ``workload.classed_requests``: an interactive (chat-turn
    sized, tight deadline) / batch (summarize-sized, loose deadline) mix
    over optional multi-model pools.
    """

    def __init__(self, n: int, *, seed: int = 0, t0: float = 0.0,
                 vocab_size: int = 256, interactive_frac: float = 0.3,
                 start_rid: int = 0,
                 model_ids: Sequence[str] = ("default",),
                 interactive: SLOClass = INTERACTIVE,
                 batch: SLOClass = BATCH):
        self.n = int(n)
        self.seed = seed
        self.t0 = float(t0)
        self.vocab_size = vocab_size
        self.interactive_frac = interactive_frac
        self.start_rid = start_rid
        self.model_ids = tuple(model_ids)
        self.interactive = interactive
        self.batch = batch

    # ------------------------------------------------------- rate profile
    def rate(self, t: float) -> float:
        """Instantaneous arrival rate at virtual time ``t``."""
        raise NotImplementedError

    @property
    def rate_max(self) -> float:
        """Tight upper envelope of ``rate`` (thinning proposal rate)."""
        raise NotImplementedError

    def segments(self, until: float) -> List[Tuple[float, float, float]]:
        """``(start, end, mean_rate)`` windows covering [t0, until]."""
        raise NotImplementedError

    def _mean_rate(self, a: float, b: float, k: int = 256) -> float:
        """Numeric mean of ``rate`` over [a, b] (midpoint rule)."""
        ts = a + (np.arange(k) + 0.5) * (b - a) / k
        return float(np.mean([self.rate(t) for t in ts]))

    # ------------------------------------------------------ request build
    def _build_request(self, rid: int, rng: np.random.Generator) -> Request:
        if rng.random() < self.interactive_frac:
            (plo, phi), (nlo, nhi) = ((3, 8), (3, 7))
            slo = self.interactive
        else:
            (plo, phi), (nlo, nhi) = ((6, 14), (10, 18))
            slo = self.batch
        return Request(
            rid=rid,
            prompt=rng.integers(0, self.vocab_size,
                                int(rng.integers(plo, phi)),
                                dtype=np.int32),
            max_new_tokens=int(rng.integers(nlo, nhi)),
            slo=slo,
            model_id=self.model_ids[rid % len(self.model_ids)])

    # ----------------------------------------------------------- stream
    def __iter__(self) -> Iterator[Tuple[float, Request]]:
        rng = np.random.default_rng(self.seed)
        rmax = float(self.rate_max)
        if not rmax > 0:
            raise ValueError(f"{type(self).__name__}: rate_max must be "
                             f"positive, got {rmax}")
        t = self.t0
        for i in range(self.n):
            # Lewis-Shedler thinning: propose at the envelope rate,
            # accept with prob rate(t)/rate_max
            while True:
                t += rng.exponential(1.0 / rmax)
                if rng.random() * rmax <= self.rate(t):
                    break
            yield t, self._build_request(self.start_rid + i, rng)


class PulseSpikes(ShapedArrivals):
    """Quiet baseline traffic punctured by periodic sharp spikes: the
    first ``spike_frac`` of every ``period`` runs at ``spike_rate``,
    the rest at ``base_rate``."""

    def __init__(self, n: int, *, base_rate: float, spike_rate: float,
                 period: float = 60.0, spike_frac: float = 0.2, **kw):
        super().__init__(n, **kw)
        self.base_rate = float(base_rate)
        self.spike_rate = float(spike_rate)
        self.period = float(period)
        self.spike_frac = float(spike_frac)

    def rate(self, t: float) -> float:
        phase = (t - self.t0) % self.period
        return (self.spike_rate if phase < self.spike_frac * self.period
                else self.base_rate)

    @property
    def rate_max(self) -> float:
        return max(self.base_rate, self.spike_rate)

    def segments(self, until: float) -> List[Tuple[float, float, float]]:
        out, start = [], self.t0
        while start < until:
            split = min(start + self.spike_frac * self.period, until)
            end = min(start + self.period, until)
            out.append((start, split, self.spike_rate))
            if end > split:
                out.append((split, end, self.base_rate))
            start = end
        return out


class Sawtooth(ShapedArrivals):
    """Linear ramp ``low -> high`` over each ``period``, then snap back
    (the classic gradual-rampup / instant-release tooth)."""

    def __init__(self, n: int, *, low: float, high: float,
                 period: float = 120.0, **kw):
        super().__init__(n, **kw)
        self.low = float(low)
        self.high = float(high)
        self.period = float(period)

    def rate(self, t: float) -> float:
        phase = ((t - self.t0) % self.period) / self.period
        return self.low + (self.high - self.low) * phase

    @property
    def rate_max(self) -> float:
        return max(self.low, self.high)

    def segments(self, until: float) -> List[Tuple[float, float, float]]:
        out, start = [], self.t0
        while start < until:
            end = min(start + self.period, until)
            out.append((start, end, self._mean_rate(start, end)))
            start = end
        return out


class Staircase(ShapedArrivals):
    """Discrete rate steps climbing ``low -> high`` across ``steps``
    levels of ``step_dur`` each, then resetting (a load-testing ladder
    that repeats)."""

    def __init__(self, n: int, *, low: float, high: float,
                 steps: int = 4, step_dur: float = 45.0, **kw):
        super().__init__(n, **kw)
        if steps < 2:
            raise ValueError("staircase needs >= 2 steps")
        self.low = float(low)
        self.high = float(high)
        self.steps = int(steps)
        self.step_dur = float(step_dur)

    def _level_rate(self, level: int) -> float:
        return self.low + (self.high - self.low) * level / (self.steps - 1)

    def rate(self, t: float) -> float:
        cycle = self.steps * self.step_dur
        level = int(((t - self.t0) % cycle) // self.step_dur)
        return self._level_rate(level)

    @property
    def rate_max(self) -> float:
        return max(self.low, self.high)

    def segments(self, until: float) -> List[Tuple[float, float, float]]:
        out, start, level = [], self.t0, 0
        while start < until:
            end = min(start + self.step_dur, until)
            out.append((start, end, self._level_rate(level)))
            level = (level + 1) % self.steps
            start = end
        return out


class Epochs(ShapedArrivals):
    """Cycle through an explicit list of rates, ``epoch_dur`` apiece —
    the shape for workloads with distinct repeating phases (train /
    eval / checkpoint epochs driving inference side-traffic)."""

    def __init__(self, n: int, *, rates: Sequence[float],
                 epoch_dur: float = 60.0, **kw):
        super().__init__(n, **kw)
        if not rates:
            raise ValueError("epochs needs at least one rate")
        self.rates = tuple(float(r) for r in rates)
        self.epoch_dur = float(epoch_dur)

    def rate(self, t: float) -> float:
        cycle = len(self.rates) * self.epoch_dur
        idx = int(((t - self.t0) % cycle) // self.epoch_dur)
        return self.rates[idx]

    @property
    def rate_max(self) -> float:
        return max(self.rates)

    def segments(self, until: float) -> List[Tuple[float, float, float]]:
        out, start, idx = [], self.t0, 0
        while start < until:
            end = min(start + self.epoch_dur, until)
            out.append((start, end, self.rates[idx]))
            idx = (idx + 1) % len(self.rates)
            start = end
        return out


class StagedPlateau(ShapedArrivals):
    """An explicit sequence of ``(rate, duration)`` plateaus, holding
    the final stage's rate forever after (so the stream always drains
    its ``n`` requests)."""

    def __init__(self, n: int, *, stages: Sequence[Tuple[float, float]],
                 **kw):
        super().__init__(n, **kw)
        if not stages:
            raise ValueError("staged_plateau needs at least one stage")
        self.stages = tuple((float(r), float(d)) for r, d in stages)

    def rate(self, t: float) -> float:
        off = t - self.t0
        for r, d in self.stages:
            if off < d:
                return r
            off -= d
        return self.stages[-1][0]

    @property
    def rate_max(self) -> float:
        return max(r for r, _ in self.stages)

    def segments(self, until: float) -> List[Tuple[float, float, float]]:
        out, start = [], self.t0
        for r, d in self.stages:
            if start >= until:
                return out
            end = min(start + d, until)
            out.append((start, end, r))
            start = end
        if start < until:
            out.append((start, until, self.stages[-1][0]))
        return out


class Diurnal(ShapedArrivals):
    """The million-user day/night cycle: a smooth sinusoid from
    ``base_rate`` (midnight trough, at ``t0``) up to ``peak_rate``
    (midday) over each ``day`` — the canonical piecewise-rate
    nonhomogeneous Poisson trace for fleet-scale runs."""

    def __init__(self, n: int, *, base_rate: float, peak_rate: float,
                 day: float = 86_400.0, **kw):
        super().__init__(n, **kw)
        self.base_rate = float(base_rate)
        self.peak_rate = float(peak_rate)
        self.day = float(day)

    def rate(self, t: float) -> float:
        phase = 2.0 * math.pi * (t - self.t0) / self.day
        # 0 at t0 (trough), 1 at half-day (peak)
        lift = 0.5 * (1.0 - math.cos(phase))
        return self.base_rate + (self.peak_rate - self.base_rate) * lift

    @property
    def rate_max(self) -> float:
        return max(self.base_rate, self.peak_rate)

    def segments(self, until: float) -> List[Tuple[float, float, float]]:
        out, start = [], self.t0
        quarter = self.day / 4.0
        while start < until:
            end = min(start + quarter, until)
            out.append((start, end, self._mean_rate(start, end)))
            start = end
        return out


def make_shape(name: str, n: int, *, rate: float, period: float = 60.0,
               seed: int = 0, **kw) -> ShapedArrivals:
    """Build a catalogue shape parameterized around a target long-run
    mean ``rate`` (requests/virtual-second).

    Each shape's amplitude is fixed relative to that mean — e.g.
    ``pulse_spikes`` idles at 0.5x and spikes to 3x — so one knob scales
    any shape to a fleet's capacity.  ``period`` sets the pattern
    length (the diurnal shape's "day").
    """
    if name == "pulse_spikes":
        # mean = 0.2*3r + 0.8*0.5r = r
        return PulseSpikes(n, base_rate=0.5 * rate, spike_rate=3.0 * rate,
                           period=period, spike_frac=0.2, seed=seed, **kw)
    if name == "sawtooth":
        return Sawtooth(n, low=0.5 * rate, high=1.5 * rate,
                        period=period, seed=seed, **kw)
    if name == "staircase":
        return Staircase(n, low=0.4 * rate, high=1.6 * rate, steps=4,
                         step_dur=period / 4.0, seed=seed, **kw)
    if name == "epochs":
        return Epochs(n, rates=(0.5 * rate, 1.5 * rate, 0.8 * rate,
                                1.2 * rate),
                      epoch_dur=period / 4.0, seed=seed, **kw)
    if name == "staged_plateau":
        return StagedPlateau(n, stages=((1.5 * rate, period),
                                        (0.5 * rate, period),
                                        (1.0 * rate, period)),
                             seed=seed, **kw)
    if name == "diurnal":
        return Diurnal(n, base_rate=0.4 * rate, peak_rate=1.6 * rate,
                       day=period, seed=seed, **kw)
    raise ValueError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")


SHAPES = {
    "pulse_spikes": PulseSpikes,
    "sawtooth": Sawtooth,
    "staircase": Staircase,
    "epochs": Epochs,
    "staged_plateau": StagedPlateau,
    "diurnal": Diurnal,
}
