"""Deterministic virtual time shared by every event-driven subsystem."""

from __future__ import annotations


class VirtualClock:
    """Monotonic fake clock: the single time source of an ``EventLoop``.

    Runs are keyed off *virtual* seconds so simulations are deterministic
    and reproducible on any host; only explicitly measured stages (e.g.
    checkpoint-store timers) use real wall-clock.
    """

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float):
        assert dt > 0
        self._t += dt

    def advance_to(self, t: float):
        """Jump forward to ``t`` (no-op if ``t`` is in the past)."""
        if t > self._t:
            self._t = float(t)
