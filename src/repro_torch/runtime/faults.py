"""One fault schedule for every subsystem (paper §IV, AWS FIS analogue).

A :class:`FaultTrace` materializes an interruption schedule — injected
explicitly, sampled from a seeded Poisson process, read from a trace
file, or driven per-purchase by the market layer (a ``SpotExchange``
buy samples the instance's interruption time from its market's
price-coupled intensity and injects it here, so interruptions are a
function of *which market each replica was bought in*) — into the full
§IV spot lifecycle per interruption:

    rebalance_recommendation  at  t
    interruption_notice       at  t + rebalance_lead
    terminate                 at  t + rebalance_lead + notice_deadline

Consumers attach in one of two ways:

* ``trace.bind(loop, kind)`` — every lifecycle event (past and future
  injections) is scheduled onto a shared :class:`EventLoop`; this is how
  ``CloudManager``, ``ServingCluster``, and the tile runtime all observe
  the *identical* timestamps from a single trace.
* ``trace.subscribe()`` / :class:`SpotEventFeed` — a poll-style cursor
  view for callers that drive their own time (legacy interface).

Beyond the graceful lifecycle, the trace also carries a *chaos* model
(``CHAOS_KINDS``): ``hard_kill`` (zero-notice termination),
``slowdown`` (speed degraded by a factor over a window),
``network_contention`` (staging/event-delivery latency inflated over a
window), and ``endpoint_failure`` (transient MigrationEndpoint
put/get errors).  Chaos faults ride the same injection, binding, and
file round-trip machinery — one seeded soup (``chaos_sampled``)
replays identically with recovery on or off.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import math
from typing import Iterable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpotNotice:
    """One fault event delivered to a subscriber.

    Spot-lifecycle kinds (``LIFECYCLE_KINDS``) only use the first four
    fields; the chaos kinds (``CHAOS_KINDS``) carry their parameters in
    the trailing defaulted fields — ``factor``/``duration`` for
    slowdown and network-contention windows, ``count`` for transient
    endpoint failures.
    """
    t: float
    kind: str       # LIFECYCLE_KINDS | CHAOS_KINDS
    target: int     # subscriber-defined id (instance / serving replica)
    lifecycle: int = -1   # interruption index in the trace: ties the three
                          # events of one lifecycle together even when the
                          # same target is interrupted repeatedly
    factor: float = 1.0   # slowdown / contention severity multiplier
    duration: float = 0.0  # window length (virtual seconds)
    count: int = 1        # transient endpoint-failure arm count


LIFECYCLE_KINDS = ("rebalance_recommendation", "interruption_notice",
                   "terminate")

# The chaos model beyond the graceful §IV lifecycle: faults that arrive
# with NO advance warning, so resilience depends on checkpoints and
# detection rather than a drain window.
CHAOS_KINDS = ("hard_kill", "slowdown", "network_contention",
               "endpoint_failure")


class FaultTrace:
    """Seeded-or-file-driven interruption schedule -> lifecycle events."""

    def __init__(self, *, rebalance_lead: float = 180.0,
                 notice_deadline: float = 120.0):
        self.rebalance_lead = rebalance_lead
        self.notice_deadline = notice_deadline
        self.interruptions: List[Tuple[float, int]] = []
        self.chaos: List[SpotNotice] = []   # injected chaos faults, in order
        # sorted by (t, seq): bisect keeps polls O(log n), no private heap
        self._events: List[Tuple[float, int, SpotNotice]] = []
        self._seq = itertools.count()
        self._sinks: List[Tuple[object, str]] = []

    # ------------------------------------------------------------ build
    @classmethod
    def sampled(cls, *, rate: float, horizon: float, targets: int,
                seed: int = 0, rebalance_lead: float = 180.0,
                notice_deadline: float = 120.0) -> "FaultTrace":
        """Poisson(``rate``/s) interruption arrivals over ``horizon`` s,
        cycling victims through ``targets`` ids — one seeded draw gives
        one schedule, replayable by any number of consumers."""
        trace = cls(rebalance_lead=rebalance_lead,
                    notice_deadline=notice_deadline)
        rng = np.random.default_rng(seed)
        t, k = 0.0, 0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= horizon:
                break
            trace.inject(t, k % targets)
            k += 1
        return trace

    @classmethod
    def chaos_sampled(cls, *, rate: float, horizon: float, targets: int,
                      seed: int = 0, kinds: Tuple[str, ...] = CHAOS_KINDS,
                      factor: float = 3.0, window: float = 45.0,
                      fail_count: int = 2, rebalance_lead: float = 180.0,
                      notice_deadline: float = 120.0) -> "FaultTrace":
        """Seeded mixed fault soup: Poisson(``rate``/s) chaos arrivals
        over ``horizon`` s, drawing each fault's kind from ``kinds`` and
        cycling victims through ``targets`` ids.  Slowdown/contention
        windows use (``factor``, ``window``); endpoint failures arm
        ``fail_count`` transient errors.  One seed, one soup — the
        recovery-on/off A/B replays the identical schedule."""
        trace = cls(rebalance_lead=rebalance_lead,
                    notice_deadline=notice_deadline)
        rng = np.random.default_rng(seed)
        t, k = 0.0, 0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= horizon:
                break
            kind = kinds[int(rng.integers(len(kinds)))]
            tgt = k % targets
            if kind == "hard_kill":
                trace.inject_hard_kill(t, tgt)
            elif kind == "slowdown":
                trace.inject_slowdown(t, tgt, factor=factor,
                                      duration=window)
            elif kind == "network_contention":
                trace.inject_contention(t, factor=factor, duration=window)
            elif kind == "endpoint_failure":
                trace.inject_endpoint_failure(t, tgt, count=fail_count)
            else:
                trace.inject(t, tgt)
            k += 1
        return trace

    @classmethod
    def from_file(cls, path: str, *, rebalance_lead: float = 180.0,
                  notice_deadline: float = 120.0) -> "FaultTrace":
        """Trace file: ``<t> <target>`` per line for spot interruptions
        (the original format), ``<t> <target> <kind> [key=val ...]`` for
        chaos kinds (# comments)."""
        trace = cls(rebalance_lead=rebalance_lead,
                    notice_deadline=notice_deadline)
        with open(path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                if len(parts) == 2:
                    t, target = parts
                    trace.inject(float(t), int(target))
                    continue
                t, target, kind = parts[:3]
                kw = dict(p.split("=", 1) for p in parts[3:])
                trace.inject_chaos(
                    float(t), int(target), kind,
                    factor=float(kw.get("factor", 1.0)),
                    duration=float(kw.get("duration", 0.0)),
                    count=int(kw.get("count", 1)))
        return trace

    def to_file(self, path: str):
        """Write the fault schedule; ``from_file`` round-trips it
        exactly (``repr`` floats) — spot lines keep the original
        two-field format, chaos lines append kind + parameters."""
        with open(path, "w") as fh:
            fh.write("# fault trace: <t> <target> [<kind> key=val ...] "
                     "per line\n")
            for t, target in self.interruptions:
                fh.write(f"{t!r} {target}\n")
            for n in self.chaos:
                fh.write(f"{n.t!r} {n.target} {n.kind} "
                         f"factor={n.factor!r} duration={n.duration!r} "
                         f"count={n.count}\n")

    def inject(self, t: float, target: int):
        """FIS analogue: schedule the full lifecycle for ``target``."""
        lc = len(self.interruptions)
        self.interruptions.append((t, target))
        t_notice = t + self.rebalance_lead
        for notice in (
                SpotNotice(t, "rebalance_recommendation", target, lc),
                SpotNotice(t_notice, "interruption_notice", target, lc),
                SpotNotice(t_notice + self.notice_deadline, "terminate",
                           target, lc)):
            self._push(notice)

    def inject_chaos(self, t: float, target: int, kind: str, *,
                     factor: float = 1.0, duration: float = 0.0,
                     count: int = 1) -> SpotNotice:
        """Schedule ONE zero-warning chaos fault (no lifecycle: the
        whole point is that nobody gets a drain window)."""
        if kind not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {kind!r}; "
                             f"choose from {CHAOS_KINDS}")
        notice = SpotNotice(t, kind, target, -1, factor, duration, count)
        self.chaos.append(notice)
        self._push(notice)
        return notice

    def inject_hard_kill(self, t: float, target: int) -> SpotNotice:
        """Terminate ``target`` at ``t`` with zero notice."""
        return self.inject_chaos(t, target, "hard_kill")

    def inject_slowdown(self, t: float, target: int, *,
                        factor: float = 3.0,
                        duration: float = 60.0) -> SpotNotice:
        """Degrade ``target``'s speed by ``factor`` for ``duration`` s
        (processor performance variability)."""
        return self.inject_chaos(t, target, "slowdown", factor=factor,
                                 duration=duration)

    def inject_contention(self, t: float, *, target: int = -1,
                          factor: float = 3.0,
                          duration: float = 60.0) -> SpotNotice:
        """Inflate migration-staging and event-delivery latency by
        ``factor`` for ``duration`` s (network contention; target -1 =
        the whole fabric)."""
        return self.inject_chaos(t, target, "network_contention",
                                 factor=factor, duration=duration)

    def inject_endpoint_failure(self, t: float, target: int, *,
                                count: int = 1) -> SpotNotice:
        """Arm ``target``'s MigrationEndpoint to fail its next ``count``
        staging operations transiently."""
        return self.inject_chaos(t, target, "endpoint_failure",
                                 count=count)

    def _push(self, notice: SpotNotice):
        seq = next(self._seq)
        bisect.insort(self._events, (notice.t, seq, notice))
        for loop, kind in self._sinks:
            loop.schedule(notice.t, kind, notice=notice)

    # ------------------------------------------------------------ consume
    def events(self) -> List[SpotNotice]:
        """Every materialized lifecycle event, time-ordered."""
        return [n for _, _, n in self._events]

    def bind(self, loop, kind: str = "spot"):
        """Deliver all lifecycle events (incl. future injections) as
        ``kind`` events on ``loop``; payload carries the ``notice``."""
        self._sinks.append((loop, kind))
        for t, _, notice in self._events:
            loop.schedule(t, kind, notice=notice)

    def subscribe(self) -> "FaultSubscription":
        return FaultSubscription(self)


class FaultSubscription:
    """Per-consumer delivery cursor over a trace.

    Tracks delivered events by identity (seq), not by a time watermark,
    so a lifecycle injected *behind* an already-polled timestamp is still
    delivered on the next poll — matching the old heap-based feed.
    Traces are small (3 events per interruption), so the linear scan per
    poll is irrelevant.
    """

    def __init__(self, trace: FaultTrace):
        self.trace = trace
        self._delivered: set = set()

    def poll(self, now: float) -> List[SpotNotice]:
        """Pop every undelivered event due at or before ``now``, in order."""
        events = self.trace._events
        hi = bisect.bisect_right(events, (now, math.inf))
        due = [(seq, n) for _, seq, n in events[:hi]
               if seq not in self._delivered]
        self._delivered.update(seq for seq, _ in due)
        return [n for _, n in due]

    @property
    def next_event_t(self) -> float:
        return next((t for t, seq, _ in self.trace._events
                     if seq not in self._delivered), math.inf)


class SpotEventFeed:
    """Back-compat view: the old poll-style feed, now a thin subscription
    over a shared :class:`FaultTrace` (pass ``trace=`` to share one
    schedule between subsystems)."""

    def __init__(self, *, rebalance_lead: float = 180.0,
                 notice_deadline: float = 120.0,
                 trace: Optional[FaultTrace] = None):
        self.trace = trace if trace is not None else FaultTrace(
            rebalance_lead=rebalance_lead, notice_deadline=notice_deadline)
        self.rebalance_lead = self.trace.rebalance_lead
        self.notice_deadline = self.trace.notice_deadline
        self._sub = self.trace.subscribe()

    def inject_interruption(self, t: float, target: int):
        self.trace.inject(t, target)

    def poll(self, now: float) -> List[SpotNotice]:
        return self._sub.poll(now)

    @property
    def next_event_t(self) -> float:
        return self._sub.next_event_t
