"""Vertical resize recommenders: when to grow/shrink a replica in place.

Two shapes, mirroring the Kube-DRM evaluation scenarios:

* ``FixedThresholdVertical`` — the "extreme" reactive shape: compare
  each replica's *instantaneous* backlog per lane against fixed
  grow/shrink thresholds and step the lane count immediately (bounded
  by a per-replica cooldown so the pool doesn't flap).
* ``SlidingWindowVertical`` — the smoothed ("guaranteed"-leaning)
  shape: the same thresholds over a sliding-window *mean* of the
  pressure signal, so one bursty tick neither grows nor shrinks the
  replica; sustained pressure does.

Both compose with ``QoSPolicy``: a shrink never goes below the lanes
currently occupied by Guaranteed-class work, and the cluster passes the
QoS ``evict_key`` to ``resize`` so any evicted slots are BestEffort
first.  Decisions are ``ResizeOrder``s; the cluster executes them and
parks evicted units for resume — a shrink moves work, never loses it.

Port of ``repro.vertical.policy``, over the port's
``cluster.control.{ResizeOrder, VerticalScalingPolicy}``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.cluster.control import (ClusterView, ResizeOrder,
                                         VerticalScalingPolicy)

from repro_torch.vertical.qos import qos_for


class FixedThresholdVertical(VerticalScalingPolicy):
    """Grow when backlog per lane exceeds ``grow_backlog`` token-units,
    shrink when it falls under ``shrink_backlog``, in ``step``-lane
    moves bounded by ``[min_batch, max_batch]`` and a per-replica
    ``cooldown`` (virtual seconds between resizes of the same replica).
    """

    name = "fixed"

    def __init__(self, *, min_batch: int = 1, max_batch: int = 8,
                 step: int = 2, grow_backlog: float = 24.0,
                 shrink_backlog: float = 4.0, cooldown: float = 6.0,
                 qos=None):
        if min_batch < 1 or max_batch < min_batch:
            raise ValueError(
                f"need 1 <= min_batch <= max_batch, got "
                f"[{min_batch}, {max_batch}]")
        if shrink_backlog >= grow_backlog:
            raise ValueError("shrink_backlog must be < grow_backlog "
                             "(hysteresis band)")
        self.min_batch = int(min_batch)
        self.max_batch = int(max_batch)
        self.step = max(int(step), 1)
        self.grow_backlog = grow_backlog
        self.shrink_backlog = shrink_backlog
        self.cooldown = cooldown
        self.qos = qos
        self._last_resize: Dict[int, float] = {}

    # ------------------------------------------------------------ signal
    def _pressure(self, rep, share: float, now: float) -> Optional[float]:
        """Backlog token-units per lane on ``rep``, including its share
        of the pool's routed-but-unplaced queue.  Subclasses may smooth;
        None means 'no decision this tick'."""
        return ((rep.engine.backlog_tokens() + share)
                / max(rep.engine.batch, 1))

    def _guaranteed_floor(self, rep) -> int:
        """Lanes a shrink must keep: live Guaranteed-class slots."""
        if self.qos is None:
            return 0
        return sum(1 for _, r in rep.engine.slot_requests()
                   if qos_for(r.slo).reserved)

    # ---------------------------------------------------------- decision
    def decide(self, view: ClusterView, now: float) -> List[ResizeOrder]:
        orders: List[ResizeOrder] = []
        for model_id in view.pools():
            pool = view.pool(model_id, "serving")
            if not pool:
                continue
            share = view.queued_cost(model_id) / len(pool)
            for rep in pool:
                pressure = self._pressure(rep, share, now)
                if pressure is None:
                    continue
                if now - self._last_resize.get(rep.rid,
                                               float("-inf")) < self.cooldown:
                    continue
                b = rep.engine.batch
                if pressure > self.grow_backlog and b < self.max_batch:
                    nb = min(b + self.step, self.max_batch)
                    orders.append(ResizeOrder(
                        rid=rep.rid, batch_size=nb,
                        reason=f"backlog/lane={pressure:.0f}"))
                    self._last_resize[rep.rid] = now
                elif pressure < self.shrink_backlog and b > self.min_batch:
                    nb = max(b - self.step, self.min_batch,
                             self._guaranteed_floor(rep))
                    if nb < b:
                        orders.append(ResizeOrder(
                            rid=rep.rid, batch_size=nb,
                            reason=f"quiet (backlog/lane="
                                   f"{pressure:.1f})"))
                        self._last_resize[rep.rid] = now
        return orders


class SlidingWindowVertical(FixedThresholdVertical):
    """Same thresholds, applied to a ``window``-second sliding mean of
    the pressure signal.  No decision until the window has at least
    ``min_samples`` ticks of history, so startup transients and single
    bursty ticks never resize anything."""

    name = "window"

    def __init__(self, *, window: float = 12.0, min_samples: int = 3,
                 **kw):
        super().__init__(**kw)
        self.window = window
        self.min_samples = max(int(min_samples), 1)
        self._samples: Dict[int, List[Tuple[float, float]]] = {}

    def _pressure(self, rep, share: float, now: float) -> Optional[float]:
        raw = super()._pressure(rep, share, now)
        hist = self._samples.setdefault(rep.rid, [])
        hist.append((now, raw))
        while hist and hist[0][0] < now - self.window:
            hist.pop(0)
        if len(hist) < self.min_samples:
            return None
        return sum(s for _, s in hist) / len(hist)


VERTICAL_POLICIES = {
    "fixed": FixedThresholdVertical,
    "window": SlidingWindowVertical,
}
