"""Admission queue + dispatch over replicated ServingEngines.

Three policies, the serving analogue of the paper's Fig 3 A/B plus the
elastic-job-scheduler deadline layer (Bhosale & Kale) on top:

* ``RoundRobinRouter`` — rate-oblivious baseline: queued requests are
  pinned to replicas cyclically, regardless of measured speed.
* ``RateAwareRouter``  — the paper's GreedyRefine applied to serving:
  requests are chares with load = remaining token-units, replicas are PEs
  with *measured* tokens/sec rates (from the shared ``RateMonitor``), and
  in-flight work is non-migratable ``base`` load.  Every dispatch round
  reclaims not-yet-admitted requests, places new arrivals on the
  earliest-finishing replica, then runs ``greedy_refine`` so placements
  self-correct as measured rates drift — with the minimum number of
  queue migrations (§III-B).  Admission order is FIFO.
* ``DeadlineAwareRouter`` — extends GreedyRefine to minimize predicted
  deadline misses: pending requests are ordered by (priority, deadline),
  the GreedyRefine assignment is simulated per replica at slot
  granularity (EDF admission as slots free; free and freshly preempted
  slots count as available now) and a repair pass relocates
  predicted-missing requests to whichever replica reduces total
  predicted misses.

Every router is **model-aware**: replicas declare a ``model_id`` (their
``InstanceType``'s pool) and a request is only ever placed on a replica
serving its model; requests whose pool currently has no admitting
replica stay queued until one appears.

Built for million-request runs:

* the admission queue is a ``collections.deque`` — ``submit`` appends
  and ``requeue`` extends the front in O(len(reqs)), instead of the old
  O(queue) wholesale list rebuild per drain (O(queue²) once thousands
  of lazily-admitted batch requests are held);
* the admitting-replicas-by-pool index is cached on the fleet's
  ``topology_epoch`` (bumped by any replica state/quarantine change)
  instead of being rebuilt on every dispatch;
* ``place_cap`` (opt-in) bounds one placement round: when the queue is
  longer than the cap, the head of the queue is placed FIFO onto free
  slots in O(cap x replicas) and the rest stays queued — the full
  GreedyRefine pass over an unbounded backlog is what made toy-scale
  routers melt at 10^6 requests.

Port of ``repro.cluster.router`` (imports redirected).
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.loadbalance import greedy_refine
from repro_torch.serving.engine import (DEFAULT_PREFILL_DISCOUNT, Request,
                                        request_cost)

from repro_torch.cluster.control import ClusterView, PlacementPolicy
from repro_torch.cluster.replica import Replica


def _pools(replicas: Sequence[Replica]) -> Dict[str, List[Replica]]:
    """Admitting replicas grouped by model pool (stable replica order)."""
    pools: Dict[str, List[Replica]] = {}
    for rep in replicas:
        if rep.admitting:
            pools.setdefault(rep.model_id, []).append(rep)
    return pools


class Router(PlacementPolicy):
    """Base: global admission queue; subclasses decide placement.

    Routers ARE the cluster's ``PlacementPolicy``: ``place`` adapts the
    historical ``dispatch(replicas, rates, now)`` signature to the
    control-plane ``ClusterView``, and the mid-stream ``rebalance``
    decision comes from the policy base class.
    """

    name = "base"

    def __init__(self):
        self.queue: Deque[Request] = deque()
        self._pool_cache: Optional[Tuple[Tuple[int, int],
                                         Dict[str, List[Replica]]]] = None
        # incremental per-pool load aggregates over the queue: the
        # control plane's headroom/backlog checks read these in O(1)
        # instead of scanning the (possibly million-deep) queue per
        # control tick.  Maintained at every queue mutation site below;
        # tiny float drift from add/remove cycles is clamped at read.
        self._q_tokens: Dict[str, float] = {}
        self._q_cost: Dict[str, float] = {}

    def _q_add(self, req: Request):
        m = req.model_id
        self._q_tokens[m] = self._q_tokens.get(m, 0.0) + req.total_tokens
        self._q_cost[m] = self._q_cost.get(m, 0.0) + request_cost(
            req, getattr(self, "prefill_discount", 1.0))

    def _q_rem(self, req: Request):
        m = req.model_id
        self._q_tokens[m] = self._q_tokens.get(m, 0.0) - req.total_tokens
        self._q_cost[m] = self._q_cost.get(m, 0.0) - request_cost(
            req, getattr(self, "prefill_discount", 1.0))

    def queued_tokens(self, model_id: Optional[str] = None) -> float:
        """Token-units queued for ``model_id`` (all pools when None)."""
        if model_id is None:
            return max(0.0, sum(self._q_tokens.values()))
        return max(0.0, self._q_tokens.get(model_id, 0.0))

    def queued_cost(self, model_id: Optional[str] = None) -> float:
        """Discounted router load queued for ``model_id``."""
        if model_id is None:
            return max(0.0, sum(self._q_cost.values()))
        return max(0.0, self._q_cost.get(model_id, 0.0))

    def submit(self, req: Request):
        self._q_add(req)
        self.queue.append(req)

    def requeue(self, reqs: Sequence[Request]):
        """Drained (checkpoint-free) requests come back to the front,
        keeping their relative order (O(len(reqs)), not O(queue))."""
        reqs = list(reqs)
        for req in reqs:
            self._q_add(req)
        self.queue.extendleft(reversed(reqs))

    def pools(self, replicas: Sequence[Replica]) -> Dict[str, List[Replica]]:
        """Admitting replicas by pool, cached on the fleet's topology
        epoch: any replica state/quarantine flip (and every launch)
        bumps ``Replica.topology_epoch``, so the index is rebuilt only
        when membership could actually have changed — not per dispatch.
        """
        key = (Replica.topology_epoch, len(replicas))
        cached = self._pool_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        pools = _pools(replicas)
        self._pool_cache = (key, pools)
        return pools

    def place(self, view: ClusterView, now: float) -> List[Replica]:
        return self.dispatch(list(view.replicas), view.rates(), now)

    def dispatch(self, replicas: List[Replica], rates: Dict[int, float],
                 now: float = 0.0) -> List[Replica]:
        """Place queued requests; returns the replicas that received work
        (so an event-driven cluster wakes exactly those)."""
        raise NotImplementedError


class RoundRobinRouter(Router):
    """Rate-oblivious baseline: cycle admitting replicas per model pool."""

    name = "round_robin"

    def __init__(self):
        super().__init__()
        self._next: Dict[str, int] = {}

    def dispatch(self, replicas: List[Replica], rates: Dict[int, float],
                 now: float = 0.0) -> List[Replica]:
        pools = self.pools(replicas)
        if not pools or not self.queue:
            return []
        touched: List[Replica] = []
        leftover: Deque[Request] = deque()
        while self.queue:
            req = self.queue.popleft()
            self._q_rem(req)
            targets = pools.get(req.model_id)
            if not targets:
                self._q_add(req)
                leftover.append(req)     # no admitting replica for pool
                continue
            n = self._next.get(req.model_id, 0)
            rep = targets[n % len(targets)]
            self._next[req.model_id] = n + 1
            rep.submit(req)
            if rep not in touched:
                touched.append(rep)
        self.queue = leftover
        return touched


class RateAwareRouter(Router):
    """GreedyRefine dispatch on measured rates (paper §III applied here)."""

    name = "rate_aware"

    def __init__(self, tolerance: float = 1.05,
                 prefill_discount: float = DEFAULT_PREFILL_DISCOUNT,
                 place_cap: Optional[int] = None):
        super().__init__()
        self.tolerance = tolerance
        # request load weights prompt tokens at the bulk-prefill discount
        # (matching ServingEngine.backlog_tokens), so prompt-heavy
        # requests don't overstate the load they will place on a replica
        self.prefill_discount = prefill_discount
        # opt-in backlog bound: over the cap, one placement round places
        # only the queue head onto free slots (O(cap x replicas)) and
        # skips the reclaim + GreedyRefine pass; None = exact behaviour
        self.place_cap = place_cap

    # ------------------------------------------------------------ hooks
    def _order_pending(self, pending: List[Request]) -> List[Request]:
        """Admission order within one placement round (FIFO here)."""
        return pending

    def _refine_assignment(self, assignment: np.ndarray,
                           targets: List[Replica], pending: List[Request],
                           loads: np.ndarray, rate: np.ndarray,
                           base: np.ndarray, now: float) -> np.ndarray:
        """Post-GreedyRefine repair hook (load-only router: identity)."""
        return assignment

    # --------------------------------------------------------- dispatch
    def dispatch(self, replicas: List[Replica], rates: Dict[int, float],
                 now: float = 0.0) -> List[Replica]:
        pools = self.pools(replicas)
        if not pools:
            return []
        if self.place_cap is not None:
            # bounded mode: never reclaim + re-place the whole backlog —
            # the queue head fills free slots and the rest STAYS in the
            # router deque (engines hold only running work), so one pass
            # is O(cap x replicas) regardless of backlog depth
            return self._fast_place(pools)
        # reclaim queued-but-unadmitted work so placement can be revised
        pending_by_model: Dict[str, List[Request]] = {}
        prev_home: Dict[int, int] = {}
        for model_id, targets in pools.items():
            for pe, rep in enumerate(targets):
                for req in rep.engine.reclaim_queue():
                    prev_home[req.rid] = pe
                    pending_by_model.setdefault(model_id, []).append(req)
        leftover: Deque[Request] = deque()
        while self.queue:
            req = self.queue.popleft()
            if req.model_id in pools:
                self._q_rem(req)
                pending_by_model.setdefault(req.model_id, []).append(req)
            else:
                leftover.append(req)
        self.queue = leftover

        touched: List[Replica] = []
        for model_id, targets in pools.items():
            pending = pending_by_model.get(model_id)
            if not pending:
                continue
            for rep in self._place_pool(targets, pending, rates,
                                        prev_home, now):
                if rep not in touched:
                    touched.append(rep)
        return touched

    def _fast_place(self, pools: Dict[str, List[Replica]]) -> List[Replica]:
        """Backlog fast path: admit the FIFO head of the queue onto free
        slots only, leaving the rest queued (the deque holds the backlog
        in O(1) memory per request instead of engine queues growing
        unboundedly).  Each completion-driven dispatch pass admits the
        next head, so admission order is identical to the exact path's
        FIFO order — only the placement refinement is skipped."""
        touched: List[Replica] = []
        leftover: Deque[Request] = deque()
        free: Dict[int, int] = {}
        scanned = 0
        while self.queue and scanned < self.place_cap:
            scanned += 1
            req = self.queue.popleft()
            targets = pools.get(req.model_id)
            if not targets:
                leftover.append(req)
                continue
            best = None
            for rep in targets:
                f = free.get(rep.rid)
                if f is None:
                    # headroom = free lanes minus work already waiting
                    # to admit into them (placed this timestamp but not
                    # yet stepped): keeps engine queues ~empty so their
                    # backlog scans stay O(active slots)
                    f = free[rep.rid] = (rep.engine.free_slots
                                         - rep.engine.n_queued)
                if f > 0 and (best is None or f > free[best.rid]):
                    best = rep
            if best is None:
                leftover.append(req)   # pool full: wait for completions
                continue
            free[best.rid] -= 1
            self._q_rem(req)
            best.submit(req)
            if best not in touched:
                touched.append(best)
        self.queue.extendleft(reversed(leftover))
        return touched

    def _place_pool(self, targets: List[Replica], pending: List[Request],
                    rates: Dict[int, float], prev_home: Dict[int, int],
                    now: float) -> List[Replica]:
        pending = self._order_pending(pending)
        rate = np.asarray([max(rates.get(r.rid, 1.0), 1e-9)
                           for r in targets])
        # in-flight slots are pinned: they contribute fixed base load
        base = np.asarray([float(r.engine.backlog_tokens())
                           for r in targets])
        loads = np.asarray([request_cost(q, self.prefill_discount)
                            for q in pending])

        # earliest-finish initial placement for requests with no home yet
        scaled = base / rate
        current = np.zeros(len(pending), dtype=np.int64)
        for i, req in enumerate(pending):
            if req.rid in prev_home:
                current[i] = prev_home[req.rid]
                scaled[current[i]] += loads[i] / rate[current[i]]
            else:
                pe = int(np.argmin(scaled + loads[i] / rate))
                current[i] = pe
                scaled[pe] += loads[i] / rate[pe]

        res = greedy_refine(loads, len(targets), rates=rate,
                            current=current, base=base,
                            tolerance=self.tolerance)
        assignment = self._refine_assignment(
            np.asarray(res.assignment), targets, pending, loads, rate,
            base, now)
        touched = []
        for i, req in enumerate(pending):
            rep = targets[int(assignment[i])]
            rep.submit(req)
            if rep not in touched:
                touched.append(rep)
        return touched


def _slo_key(req: Request) -> Tuple[int, float, int]:
    prio = req.slo.priority if req.slo is not None else 1
    return (prio, req.deadline_t(), req.rid)


class DeadlineAwareRouter(RateAwareRouter):
    """GreedyRefine extended to minimize predicted deadline misses.

    On top of the rate-aware placement: pending requests are admitted in
    (priority, deadline) order — interactive work queue-jumps batch work
    — and the GreedyRefine assignment is repaired by relocating requests
    predicted to miss their deadline (slot-level EDF simulation per
    replica at the measured rate: free — including freshly preempted or
    drained — slots admit immediately, active slots free at their
    predicted completion) onto the replica that minimizes total
    predicted misses.
    """

    name = "slo_aware"

    def __init__(self, tolerance: float = 1.05,
                 prefill_discount: float = DEFAULT_PREFILL_DISCOUNT,
                 max_repairs: int = 32,
                 place_cap: Optional[int] = None):
        super().__init__(tolerance, prefill_discount, place_cap=place_cap)
        self.max_repairs = max_repairs

    def _order_pending(self, pending: List[Request]) -> List[Request]:
        return sorted(pending, key=_slo_key)

    def _slot_free_times(self, targets: List[Replica],
                         rate: np.ndarray) -> List[List[float]]:
        """Per-replica slot-availability offsets for the EDF simulation.

        Every currently-free slot is available *immediately* — including
        slots just freed by a preemption or a drain — and every active
        slot frees at its predicted completion.  Restore-queue units
        (admitted ahead of fresh work) claim the earliest slots first.
        The old serial model charged the whole base backlog before any
        queued request could start, so a replica with one long slot and
        three freed ones looked as busy as a fully loaded engine.
        """
        out = []
        for pe, rep in enumerate(targets):
            free = [0.0] * rep.engine.free_slots
            free += [c / rate[pe] for _, c in rep.engine.slot_costs()]
            heapq.heapify(free)
            for c in rep.engine.restore_costs(self.prefill_discount):
                start = heapq.heappop(free) if free else 0.0
                heapq.heappush(free, start + c / rate[pe])
            out.append(free or [0.0])
        return out

    def _predicted_misses(self, assignment: np.ndarray, loads: np.ndarray,
                          rate: np.ndarray,
                          slot_free: List[List[float]],
                          deadlines: np.ndarray,
                          now: float) -> Tuple[int, List[int]]:
        """Simulate slot-level EDF service per replica; count predicted
        misses.  ``pending`` is already in (priority, deadline) order,
        so each replica admits its assigned requests in EDF order as
        slots free up — queued work runs in parallel across slots, not
        serially behind the entire base load."""
        misses, missed = 0, []
        for pe in range(len(rate)):
            free = list(slot_free[pe])
            heapq.heapify(free)
            for i in np.flatnonzero(assignment == pe):
                start = heapq.heappop(free)
                done = start + loads[i] / rate[pe]
                heapq.heappush(free, done)
                if now + done > deadlines[i]:
                    misses += 1
                    missed.append(int(i))
        return misses, missed

    def _refine_assignment(self, assignment: np.ndarray,
                           targets: List[Replica], pending: List[Request],
                           loads: np.ndarray, rate: np.ndarray,
                           base: np.ndarray, now: float) -> np.ndarray:
        deadlines = np.asarray([q.deadline_t() for q in pending])
        if not np.isfinite(deadlines).any() or len(targets) < 2:
            return assignment
        slot_free = self._slot_free_times(targets, rate)
        best, missed = self._predicted_misses(
            assignment, loads, rate, slot_free, deadlines, now)
        repairs = 0
        while missed and best > 0 and repairs < self.max_repairs:
            improved = False
            # most urgent predicted miss first
            for i in sorted(missed, key=lambda j: deadlines[j]):
                home = int(assignment[i])
                for pe in range(len(targets)):
                    if pe == home:
                        continue
                    trial = assignment.copy()
                    trial[i] = pe
                    m, mi = self._predicted_misses(
                        trial, loads, rate, slot_free, deadlines, now)
                    if m < best:
                        assignment, best, missed = trial, m, mi
                        improved = True
                        break
                if improved:
                    break
            repairs += 1
            if not improved:
                break
        return assignment


ROUTERS = {
    "round_robin": RoundRobinRouter,
    "rate_aware": RateAwareRouter,
    "slo_aware": DeadlineAwareRouter,
}
