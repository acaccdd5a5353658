"""Shared discrete-event runtime core (the paper's ARTS substrate).

One clock, one event heap, one fault schedule.  Every time-driven
subsystem in the reproduction — the ``CloudManager`` spot simulation,
the serving cluster's replicas, and the overdecomposed tile runtime —
registers named handlers on a shared :class:`EventLoop` instead of
owning a private heap, so training and serving experiments replay the
*identical* interruption schedule from a single :class:`FaultTrace`.

This is the message-driven core the paper argues for (§II): no global
lockstep tick; each actor schedules its own next event at its own
cadence.

A copy of ``repro/runtime`` (Python and numpy only): the port imports
nothing of ``repro``, and seeded runs of the two give the same
``EventLoop.journal_digest``.
"""

from repro_torch.runtime.clock import VirtualClock
from repro_torch.runtime.loop import Event, EventLoop
from repro_torch.runtime.faults import (FaultTrace, SpotEventFeed,
                                        SpotNotice, CHAOS_KINDS,
                                        LIFECYCLE_KINDS)

__all__ = [
    "VirtualClock", "Event", "EventLoop",
    "FaultTrace", "SpotEventFeed", "SpotNotice", "CHAOS_KINDS",
    "LIFECYCLE_KINDS",
]
