"""ControlPlane: pluggable policies over a read-only cluster view.

The paper's thesis is a *separation of mechanism and policy*: migratable
objects with one pack/unpack interface are the mechanism; load
balancing, spot handling and elastic scaling are policies layered on
top.  This module is the policy layer for the serving cluster.  Each
policy consumes a read-only ``ClusterView`` and returns *decisions*
(orders / plans); the ``ServingCluster`` executes them through the
WorkUnit verbs, and its event handlers reduce to thin dispatch.

Three policy seams:

* ``PlacementPolicy``  — where queued requests go and which in-flight
  units migrate for load.  The existing routers (round-robin,
  rate-aware GreedyRefine, deadline-aware) ARE placement policies
  (``repro.cluster.router``); the base class also owns the recurring
  mid-stream ``rebalance`` decision (ETA-ratio gated, one move per pool,
  strict worst-ETA improvement).
* ``PreemptionPolicy`` — who waits at the door (lazy-admission headroom
  gate) and who gets *paused*.  ``SLOPreemption`` preempts batch-class
  slots when waiting interactive work would otherwise miss its deadline
  — freeing capacity through the same pack/unpack mechanism as a drain,
  and resuming the paused units (bit-identically) once the pressure
  clears.
* ``ScalingPolicy``    — when each model pool grows or shrinks and
  WHICH instance type to buy.  ``BacklogScaling`` reproduces the
  backlog/SLO-pressure thresholds; ``CostAwareScaling`` additionally
  selects instance types by measured price-performance over
  ``InstanceType.cost_per_hour`` (the elastic-scheduler follow-up of
  Bhosale & Kale: cost-aware instance selection on the same migratable
  abstraction).

Port of ``repro.cluster.control`` (imports redirected).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.engine import Request, request_cost
from repro_torch.serving.workunit import WorkUnit

from repro_torch.cluster.replica import InstanceType, Replica, ReplicaState


# ---------------------------------------------------------------- view
class ClusterView:
    """Read-only window onto cluster state for control-plane policies.

    Policies decide; the cluster executes.  Everything here is either a
    measured signal (rates, backlogs, overdue counts) or bookkeeping
    state (queues, pools, paused units).  ``log`` is the one write — a
    timeline annotation, so policy decisions stay observable.
    """

    def __init__(self, cluster):
        self._cl = cluster

    # ------------------------------------------------------------ time
    @property
    def now(self) -> float:
        return self._cl.clock.now()

    def log(self, msg: str):
        self._cl.log(self.now, msg)

    # ----------------------------------------------------------- fleet
    @property
    def replicas(self) -> Tuple[Replica, ...]:
        return tuple(self._cl.replicas)

    def rates(self) -> Dict[int, float]:
        """Measured, normalized rates keyed by replica id."""
        return self._cl.rates()

    def pools(self) -> List[str]:
        return sorted({r.model_id for r in self._cl.replicas})

    def pool(self, model_id: str,
             state: str = "admitting") -> List[Replica]:
        """Pool members by coarse state: admitting | serving | launching."""
        if state == "admitting":
            keep = lambda r: r.admitting            # noqa: E731
        elif state == "serving":
            keep = lambda r: r.serving              # noqa: E731
        elif state == "launching":
            keep = lambda r: r.state == ReplicaState.LAUNCHING  # noqa: E731
        else:
            raise ValueError(f"unknown pool state filter {state!r}")
        return [r for r in self._cl.replicas
                if keep(r) and r.model_id == model_id]

    # ------------------------------------------------------------ work
    def queued(self, model_id: Optional[str] = None) -> List[Request]:
        """Router-level queue (not yet placed on any replica)."""
        return [q for q in self._cl.router.queue
                if model_id is None or q.model_id == model_id]

    def waiting(self, rep: Replica) -> Tuple[Request, ...]:
        """Placed-but-unadmitted requests on one replica's engine."""
        return rep.engine.queued_requests()

    def held(self, model_id: Optional[str] = None) -> List[Request]:
        """Lazily-admitted arrivals still held at the door."""
        return [q for q in self._cl._held
                if model_id is None or q.model_id == model_id]

    def paused(self, model_id: Optional[str] = None) -> List[WorkUnit]:
        """Preempted units parked by the cluster, oldest first."""
        return [u for u in self._cl._paused
                if model_id is None or u.request.model_id == model_id]

    def overdue(self, model_id: Optional[str] = None) -> Dict[str, int]:
        """Per-class live requests already past their deadline."""
        return self._cl.metrics.overdue(self.now, model_id=model_id)

    @property
    def prefill_discount(self) -> float:
        return getattr(self._cl.router, "prefill_discount", 1.0)

    def queued_tokens(self, model_id: str) -> float:
        """Token-units in the router queue for a pool — O(1) via the
        router's incremental aggregate (falls back to a scan for
        routers that don't maintain one)."""
        fn = getattr(self._cl.router, "queued_tokens", None)
        if fn is not None:
            return fn(model_id)
        return sum(q.total_tokens for q in self.queued(model_id))

    def queued_cost(self, model_id: str) -> float:
        """Discounted router load queued for a pool — O(1), as above."""
        fn = getattr(self._cl.router, "queued_cost", None)
        if fn is not None:
            return fn(model_id)
        return sum(request_cost(q, self.prefill_discount)
                   for q in self.queued(model_id))

    def pool_backlog(self, model_id: str) -> float:
        """Pending token-units across the pool: in-engine + routed +
        held + paused (paused work is still owed service)."""
        backlog = sum(r.backlog_tokens()
                      for r in self.pool(model_id, "serving"))
        backlog += self.queued_tokens(model_id)
        backlog += sum(q.total_tokens for q in self.held(model_id))
        backlog += sum(u.remaining_tokens for u in self.paused(model_id))
        return backlog


# ----------------------------------------------------------- decisions
@dataclasses.dataclass
class MigrationPlan:
    """One mid-stream move: pack ``slot`` on ``src``, unpack on ``dst``."""
    src: int                 # source replica rid
    slot: int                # engine slot to pack
    dst: int                 # destination replica rid


@dataclasses.dataclass
class PreemptOrder:
    """Pause ``slots`` on replica ``rid`` (units parked by the cluster)."""
    rid: int
    slots: List[int]


@dataclasses.dataclass
class ResumeOrder:
    """Re-admit parked ``units`` on replica ``rid``."""
    rid: int
    units: List[WorkUnit]


@dataclasses.dataclass
class ScaleDecision:
    """Grow/shrink one pool: launch an instance and/or retire a replica."""
    launch: Optional[InstanceType] = None
    retire: Optional[int] = None     # replica rid to drain + terminate
    reason: str = ""


@dataclasses.dataclass
class ResizeOrder:
    """Vertically resize replica ``rid`` in place (no drain).

    ``None`` fields keep the replica's current value; the cluster
    executes the order through ``Replica.resize`` and parks any evicted
    units for resume, so a shrink never loses work.
    """
    rid: int
    batch_size: Optional[int] = None
    decode_block: Optional[int] = None
    kv_pool_blocks: Optional[int] = None
    reason: str = ""


# ---------------------------------------------------------- placement
class PlacementPolicy:
    """Routing + mid-stream migration decisions.

    ``place`` routes queued requests (the admission queue lives on the
    policy — the existing ``Router`` subclasses adapt by implementing it
    over ``view.replicas`` / ``view.rates()``).  ``rebalance`` returns
    ``MigrationPlan``s; the cluster executes them via pack/unpack.
    """

    name = "base"

    def place(self, view: ClusterView, now: float) -> List[Replica]:
        """Place queued requests; returns replicas that received work."""
        raise NotImplementedError

    def rebalance(self, view: ClusterView, now: float,
                  ratio: float = 1.75) -> List[MigrationPlan]:
        """Proactive mid-stream migration (one move per model pool per
        pass): when the slowest-draining replica's ETA exceeds the
        fastest's by ``ratio``, its costliest in-flight slot moves to
        the least-loaded replica with a free slot — measured rates and
        prefill-discounted backlog only, and only when the move strictly
        improves the pool's worst ETA."""
        rates = view.rates()

        def eta(r: Replica) -> float:
            return (r.engine.backlog_tokens()
                    / max(rates.get(r.rid, 1e-9), 1e-9))

        plans: List[MigrationPlan] = []
        for model_id in view.pools():
            pool = view.pool(model_id)
            if len(pool) < 2:
                continue
            src = max(pool, key=eta)
            dsts = [r for r in pool
                    if r is not src and r.engine.free_slots > 0]
            if not dsts:
                continue
            dst = min(dsts, key=eta)
            if eta(src) <= ratio * eta(dst) + 1e-9:
                continue
            costs = src.engine.slot_costs()
            if not costs:
                continue          # backlog is queue-only: router's job
            slot, cost = max(costs, key=lambda sc: sc[1])
            r_src = max(rates.get(src.rid, 1e-9), 1e-9)
            r_dst = max(rates.get(dst.rid, 1e-9), 1e-9)
            new_worst = max(
                (src.engine.backlog_tokens() - cost) / r_src,
                (dst.engine.backlog_tokens() + cost) / r_dst)
            if new_worst >= eta(src):
                continue          # move would not improve the worst ETA
            plans.append(MigrationPlan(src=src.rid, slot=slot,
                                       dst=dst.rid))
        return plans


# ---------------------------------------------------------- preemption
class PreemptionPolicy:
    """Admission-hold + pause/resume decisions.

    The base policy never preempts: it only implements the lazy-admission
    headroom gate (hold batch-class arrivals while the pool's discounted
    backlog per admitting replica exceeds ``batch_admit_headroom``) and a
    liveness fallback for ``resume`` — any parked unit re-admits as soon
    as its pool has a free slot, so no policy can strand paused work.
    """

    name = "none"

    def __init__(self, batch_admit_headroom: float = 64.0):
        self.batch_admit_headroom = batch_admit_headroom

    # -------------------------------------------------- admission gate
    def headroom(self, view: ClusterView, model_id: str) -> bool:
        """True when the pool's discounted backlog per admitting replica
        is under ``batch_admit_headroom`` token-units."""
        pool = view.pool(model_id)
        if not pool:
            return False
        backlog = sum(r.engine.backlog_tokens() for r in pool)
        backlog += view.queued_cost(model_id)
        return backlog / len(pool) < self.batch_admit_headroom

    def hold(self, req: Request, view: ClusterView) -> bool:
        """Arrival-time gate for lazily-admitted classes."""
        return not self.headroom(view, req.model_id)

    def admit_held(self, held: Sequence[Request], view: ClusterView
                   ) -> Tuple[List[Request], List[Request]]:
        """Split held arrivals into (admit now, keep holding)."""
        admit, still = [], []
        for req in held:
            (admit if self.headroom(view, req.model_id)
             else still).append(req)
        return admit, still

    # --------------------------------------------------- pause/resume
    def preempt(self, view: ClusterView, now: float) -> List[PreemptOrder]:
        return []

    def resume(self, view: ClusterView, now: float) -> List[ResumeOrder]:
        """Liveness fallback: park nothing forever — each pool's paused
        units re-admit (oldest first) onto the least-loaded admitting
        replica as soon as slots free up."""
        orders: List[ResumeOrder] = []
        rates = view.rates()
        for model_id in view.pools():
            paused = view.paused(model_id)
            if not paused or not self._pool_quiet(view, model_id, now,
                                                  rates):
                continue
            # capacity already claimed by placed-but-unadmitted requests
            # is NOT free: unpacked units enter the restore queue, which
            # admits ahead of fresh work, so resuming into a claimed
            # slot would steal it back from the request the preemption
            # freed it for
            pool = sorted(
                [r for r in view.pool(model_id)
                 if self._spare_slots(view, r) > 0],
                key=lambda r: r.engine.backlog_tokens()
                / max(rates.get(r.rid, 1e-9), 1e-9))
            i = 0
            for r in pool:          # spread units over the spare capacity
                if i >= len(paused):
                    break
                take = self._spare_slots(view, r)
                orders.append(ResumeOrder(rid=r.rid,
                                          units=paused[i:i + take]))
                i += take
        return orders

    @staticmethod
    def _spare_slots(view: ClusterView, rep: Replica) -> int:
        """Free slots not already claimed by waiting (placed) requests."""
        return max(rep.engine.free_slots - len(view.waiting(rep)), 0)

    def _pool_quiet(self, view: ClusterView, model_id: str, now: float,
                    rates: Dict[int, float]) -> bool:
        """Hook: is it safe to re-admit paused work into this pool?
        The base policy always says yes (pure liveness)."""
        return True


class SLOPreemption(PreemptionPolicy):
    """SLO-aware preemption: pause batch-class slots when waiting
    interactive work would miss its deadline.

    On every pass, each saturated replica (no free slots) is checked for
    *urgent* waiting requests — placed-but-unadmitted work with a finite
    deadline that the replica's measured rate predicts it will miss
    (service can only start once a slot frees; the wait is the smallest
    remaining slot cost).  For each such request, the costliest
    lower-priority preemptible (``admit_lazily``) slot is paused: the
    slot frees immediately through the same pack mechanism as a drain,
    the unit parks at the cluster, and nothing is lost — the paused
    stream resumes bit-identically once the pool is quiet again.
    """

    name = "slo"

    def __init__(self, batch_admit_headroom: float = 64.0,
                 slack: float = 0.0, max_preempts_per_pass: int = 4):
        super().__init__(batch_admit_headroom)
        self.slack = slack
        self.max_preempts_per_pass = max(int(max_preempts_per_pass), 1)

    # ------------------------------------------------------- urgency
    def _urgent_waiting(self, rep: Replica, view: ClusterView,
                        now: float,
                        rates: Dict[int, float]) -> List[Request]:
        """Waiting requests on ``rep`` predicted to miss their deadline
        if slots only free naturally.

        Queue depth matters: the k-th waiting request can start only
        when k slots have freed, so slot-free times are simulated (a
        tiny EDF pass over remaining slot costs at the measured rate) —
        otherwise everyone behind the first freed slot looks fine until
        it is too late to preempt for them.
        """
        rate = max(rates.get(rep.rid, 1e-9), 1e-9)
        # when each slot can next start new work (0 = free now)
        free_at = [0.0] * rep.engine.free_slots
        free_at += [c / rate for _, c in rep.engine.slot_costs()]
        free_at.sort()
        urgent = []
        for q in sorted(view.waiting(rep),
                        key=lambda q: (q.slo.priority if q.slo else 1,
                                       q.deadline_t(), q.rid)):
            if not free_at:
                break
            start = heapq.heappop(free_at)
            service = request_cost(q, view.prefill_discount) / rate
            heapq.heappush(free_at, start + service)
            dl = q.deadline_t()
            if dl == float("inf"):
                continue
            if q.slo is not None and q.slo.admit_lazily:
                continue          # lazy classes never trigger preemption
            if now + start + service > dl - self.slack:
                urgent.append(q)
        return urgent

    def preempt(self, view: ClusterView, now: float) -> List[PreemptOrder]:
        """Pool-level decision: free as many slots as the pool's urgent
        demand exceeds its free capacity, pausing the costliest
        lower-priority batch slots anywhere in the pool.  Freeing across
        the pool (not just under the replica where the urgent work
        happens to be queued) matters: the router re-places every
        dispatch, so freed capacity on ANY replica is reachable, and a
        surge concentrated by one placement pass still fans out."""
        orders: List[PreemptOrder] = []
        budget = self.max_preempts_per_pass
        rates = view.rates()         # one snapshot per pass, not per replica
        for model_id in view.pools():
            if budget <= 0:
                break
            pool = view.pool(model_id)
            urgent = [q for rep in pool
                      for q in self._urgent_waiting(rep, view, now, rates)]
            if not urgent:
                continue
            spare = sum(r.engine.free_slots for r in pool)
            need = len(urgent) - spare
            if need <= 0:
                continue
            top = min(q.slo.priority for q in urgent if q.slo is not None)
            victims = []              # (remaining cost, rid, slot)
            for rep in pool:
                cost_by_slot = dict(rep.engine.slot_costs())
                victims.extend(
                    (cost_by_slot.get(slot, 0.0), rep.rid, slot)
                    for slot, req in rep.engine.slot_requests()
                    if req.slo is not None and req.slo.admit_lazily
                    and req.slo.priority > top)
            victims.sort(reverse=True)      # costliest first
            take = min(need, len(victims), budget)
            budget -= take
            by_rid: Dict[int, List[int]] = {}
            for _cost, rid, slot in victims[:take]:
                by_rid.setdefault(rid, []).append(slot)
            orders.extend(PreemptOrder(rid=rid, slots=slots)
                          for rid, slots in sorted(by_rid.items()))
        return orders

    def _pool_quiet(self, view: ClusterView, model_id: str, now: float,
                    rates: Dict[int, float]) -> bool:
        """Resume only once no admitting replica in the pool has urgent
        waiting work — otherwise the resumed unit would immediately be
        preempted again (churn)."""
        return not any(self._urgent_waiting(rep, view, now, rates)
                       for rep in view.pool(model_id))


PREEMPTION_POLICIES = {"none": PreemptionPolicy, "slo": SLOPreemption}


# ------------------------------------------------------------- scaling
class ScalingPolicy:
    """Per-pool grow/shrink decisions (the elastic-scheduler layer).

    Scale-up triggers on sustained backlog per replica OR decided
    deadline misses (overdue live requests); scale-down retires the
    slowest replica after a sustained idle window.  Hysteresis timers
    live on the policy, so swapping policies swaps the *whole* decision,
    not just thresholds.  ``select_itype``/``replacement`` are the
    instance-type choice seams ``CostAwareScaling`` overrides.
    """

    name = "backlog"

    def __init__(self, *, scale_up_backlog: float = 128.0,
                 scale_up_patience: float = 30.0,
                 scale_down_idle: float = 120.0,
                 min_replicas: int = 1, max_replicas: int = 8,
                 slo_scale_up: bool = True,
                 default_itype: Optional[InstanceType] = None):
        self.scale_up_backlog = scale_up_backlog
        self.scale_up_patience = scale_up_patience
        self.scale_down_idle = scale_down_idle
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.slo_scale_up = slo_scale_up
        self.default_itype = default_itype
        # per-model-pool hysteresis timers
        self._over_since: Dict[str, float] = {}
        self._idle_since: Dict[str, float] = {}

    # -------------------------------------------- instance selection
    def select_itype(self, view: ClusterView, model_id: str,
                     serving: Sequence[Replica]) -> InstanceType:
        """Which instance type to launch into ``model_id``.

        A ``default_itype`` serving a different pool is never silently
        substituted: the fallback to the pool's own type is logged on
        the cluster timeline (construction already rejected defaults
        that serve NO pool — see ``ServingCluster``)."""
        itype = self.default_itype or serving[0].itype
        if itype.model_id != model_id:
            fallback = serving[0].itype
            view.log(f"scale_up pool={model_id}: default_itype "
                     f"{itype.name} serves pool {itype.model_id!r}; "
                     f"using {fallback.name} instead")
            itype = fallback
        return itype

    def replacement(self, view: ClusterView,
                    rep: Replica) -> InstanceType:
        """Instance type to pre-warm when ``rep`` got a rebalance
        recommendation (spot Mode C).  Like-for-like by default."""
        return rep.itype

    # ------------------------------------------------------ decision
    def decide(self, view: ClusterView, model_id: str,
               now: float) -> Optional[ScaleDecision]:
        serving = view.pool(model_id, "serving")
        launching = view.pool(model_id, "launching")
        if not serving:
            return None
        backlog = view.pool_backlog(model_id)
        per_replica = backlog / max(len(serving) + len(launching), 1)
        # SLO pressure: live requests already past their deadline are
        # decided misses — the pool is under-provisioned for that class
        overdue = (sum(view.overdue(model_id).values())
                   if self.slo_scale_up else 0)

        # scale up on sustained backlog or sustained deadline pressure
        if per_replica > self.scale_up_backlog or overdue > 0:
            self._idle_since.pop(model_id, None)
            if model_id not in self._over_since:
                self._over_since[model_id] = now
            elif (now - self._over_since[model_id] >= self.scale_up_patience
                    and len(serving) + len(launching) < self.max_replicas):
                del self._over_since[model_id]
                itype = self.select_itype(view, model_id, serving)
                why = (f"overdue={overdue}" if overdue
                       else f"backlog/replica={per_replica:.0f}")
                return ScaleDecision(launch=itype, reason=why)
            return None
        self._over_since.pop(model_id, None)

        # scale down a surplus replica after a sustained idle window
        if backlog == 0 and not launching \
                and len(serving) > self.min_replicas:
            if model_id not in self._idle_since:
                self._idle_since[model_id] = now
            elif now - self._idle_since[model_id] >= self.scale_down_idle:
                del self._idle_since[model_id]
                rates = view.rates()
                victim = min(serving,
                             key=lambda r: rates.get(r.rid, 1.0))
                return ScaleDecision(retire=victim.rid,
                                     reason="sustained idle")
        else:
            self._idle_since.pop(model_id, None)
        return None


class BacklogScaling(ScalingPolicy):
    """The original backlog behaviour, named: thresholds only, like-for-like
    instance types."""

    name = "backlog"


class CostAwareScaling(ScalingPolicy):
    """Cost-aware per-pool instance selection over a catalog.

    Same grow/shrink triggers as ``BacklogScaling``, but every launch
    (scale-up AND spot replacement) shops a catalog of instance types:
    the pool-compatible type with the best price-performance
    (``speed / cost_per_hour``) wins, cheapest first on ties.  This is
    the Bhosale & Kale elastic-scheduler move — instance-type selection
    as a policy over the same migratable-unit mechanism.
    """

    name = "cost_aware"

    def __init__(self, catalog: Sequence[InstanceType], **kw):
        super().__init__(**kw)
        if not catalog:
            raise ValueError("CostAwareScaling needs a non-empty catalog")
        self.catalog = tuple(catalog)

    def _best(self, model_id: str) -> Optional[InstanceType]:
        fits = [it for it in self.catalog if it.model_id == model_id]
        if not fits:
            return None
        return max(fits, key=lambda it: (
            it.speed / max(it.cost_per_hour, 1e-9), -it.cost_per_hour))

    def select_itype(self, view: ClusterView, model_id: str,
                     serving: Sequence[Replica]) -> InstanceType:
        best = self._best(model_id)
        if best is None:
            return super().select_itype(view, model_id, serving)
        view.log(f"scale_up pool={model_id}: cost-aware pick "
                 f"{best.name} (speed/$={best.speed / best.cost_per_hour:.2f})")
        return best

    def replacement(self, view: ClusterView,
                    rep: Replica) -> InstanceType:
        return self._best(rep.model_id) or rep.itype


SCALING_POLICIES = {"backlog": BacklogScaling, "cost_aware": CostAwareScaling}


# ---------------------------------------------------- vertical scaling
class VerticalScalingPolicy:
    """Per-replica in-place resize decisions (the Kube-DRM layer).

    Horizontal scaling buys whole instances — full launch latency, full
    ``cost_per_hour``; vertical scaling resizes a live replica's slot
    count in place (the K8s in-place pod-resize move), so a surge can be
    absorbed on hardware already paid for.  The base policy recommends
    nothing; the concrete recommenders live in
    ``repro.vertical.policy`` (fixed-threshold vs sliding-window —
    the Kube-DRM "extreme" vs smoothed shapes) and are registered in
    ``repro.vertical.VERTICAL_POLICIES``.

    Contract: ``decide`` consumes the read-only view and returns
    ``ResizeOrder``s; the cluster executes them, parks evicted units,
    and meters grows/shrinks/evictions in ``ClusterMetrics``.
    """

    name = "vertical_base"

    def decide(self, view: ClusterView, now: float) -> List[ResizeOrder]:
        return []


# -------------------------------------------------------- control plane
@dataclasses.dataclass
class ControlPlane:
    """The cluster's policy seams, swappable independently.

    ``fallback`` is the market-mode fourth seam (a
    ``repro.market.FallbackStrategy``): where replacement capacity
    comes from when a spot notice fires.  None outside market runs.
    ``straggler`` is the chaos-mode fifth seam (a
    ``repro.cluster.health.StragglerPolicy``): quarantine/release
    decisions over measured rates, evaluated on the control tick.
    None disables straggler mitigation.
    ``vertical`` is the elasticity sixth seam (a
    ``VerticalScalingPolicy``): in-place replica resize decisions,
    evaluated on the control tick.  None disables vertical scaling.
    """
    placement: PlacementPolicy
    preemption: PreemptionPolicy
    scaling: ScalingPolicy
    fallback: Optional[object] = None
    straggler: Optional[object] = None
    vertical: Optional[VerticalScalingPolicy] = None
