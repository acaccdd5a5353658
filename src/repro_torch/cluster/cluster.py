"""ServingCluster: message-driven replicas on the shared event runtime.

The serving analogue of the paper's adaptive runtime: ``ServingEngine``
replicas are PEs, in-flight requests are migratable chares packed into
``WorkUnit``s, and every control decision — routing, mid-stream
rebalancing, SLO-aware preemption, spot handling, elastic scaling — is a
pluggable policy on the ``ControlPlane`` (``repro.cluster.control``)
operating over a read-only ``ClusterView``.  The cluster itself owns
only *mechanism*: it schedules events, executes policy orders through
the one pack/unpack verb set, and keeps the books.

There is no global lockstep tick.  The cluster registers named handlers
on one ``repro.runtime.EventLoop``:

* ``arrival``       — a request reaches the admission gate (scheduled
                      one-by-one by an open-loop ``ArrivalProcess`` or
                      ``submit``); the preemption policy may hold
                      lazily-admitted classes at the door;
* ``spot``          — one §IV lifecycle event from the bound
                      ``FaultTrace`` (shareable with ``CloudManager``);
* ``replica_step``  — ``decode_block`` fused engine steps on one replica
                      in ONE dispatch (``ServingEngine.step_many``); each
                      replica re-schedules its own next step after the
                      accounted cost of the batch (``decode_block/speed``
                      + discounted bulk-prefill chunk tokens) while it
                      has work, so a slow replica never quantizes a fast
                      one to a global ``dt``;
* ``replica_ready`` — a pre-warmed replacement comes up;
* ``control``       — periodic scaling-policy evaluation while work
                      pends;
* ``rebalance``     — periodic mid-stream migration pass: the placement
                      policy returns ``MigrationPlan``s and in-flight
                      units move through pack/unpack (the Charm++
                      migratable-chare move, exploited *proactively* for
                      load — not just at spot-drain).

After every state-changing event one ``_dispatch`` pass runs: re-admit
parked units, ask the preemption policy about held arrivals, let the
placement policy route, then let the preemption policy pause
batch-class slots whose replicas have urgent waiting work (and resume
parked units once the pressure clears).  All policy decisions consume
*measured* rates from the shared ``RateMonitor`` — never the
InstanceType ground truth.

Port of ``repro.cluster.cluster``.  The fleet lives on one ``device``
(the card unless the caller asks for ``"cpu"``), and every replica's
engine and endpoint are built there.  ``engine=`` takes an engine class
or factory (e.g. ``functools.partial(ServingEngine, cache_mode="paged",
block_size=16)``) or ``"sim"``.
"""

from __future__ import annotations

import itertools
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.checkpointing import InMemoryStore
from repro_torch.core.rates import RateMonitor
from repro_torch.device import resolve_device
from repro_torch.runtime import (CHAOS_KINDS, EventLoop, FaultTrace,
                                 VirtualClock)
from repro_torch.serving.engine import Request
from repro_torch.serving.workload import STANDARD, SLOClass
from repro_torch.serving.workunit import WorkUnit

from repro_torch.cluster.autoscaler import Autoscaler
from repro_torch.cluster.checkpoint import CheckpointPolicy
from repro_torch.cluster.control import (ClusterView, ControlPlane,
                                         PreemptionPolicy, ScalingPolicy)
from repro_torch.cluster.endpoint import EndpointUnavailable
from repro_torch.cluster.health import (FailureDetector, QuarantineOrder,
                                        StragglerPolicy)
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.cluster.replica import InstanceType, Replica, ReplicaState
from repro_torch.cluster.router import RateAwareRouter, Router

# re-exported for callers that only import the cluster module
__all__ = ["ServingCluster", "ClusterView", "ControlPlane"]


class ServingCluster:
    def __init__(self, cfg: ModelConfig, params,
                 fleet: Sequence[InstanceType], *,
                 router: Optional[Router] = None,
                 batch_size: int = 2, max_seq: int = 64,
                 temperature: float = 0.0,
                 decode_block: int = 4, prefill_mode: str = "chunked",
                 dt: float = 1.0, seed: int = 0,
                 rebalance_lead: float = 180.0,
                 notice_deadline: float = 120.0,
                 trace: Optional[FaultTrace] = None,
                 autoscaler_kw: Optional[dict] = None,
                 models: Optional[Dict[str, Tuple[ModelConfig,
                                                  object]]] = None,
                 admission: str = "fifo",
                 batch_admit_headroom: float = 64.0,
                 default_slo: SLOClass = STANDARD,
                 rebalance_interval: Optional[float] = None,
                 rebalance_ratio: float = 1.75,
                 preemption: Optional[PreemptionPolicy] = None,
                 scaling: Optional[ScalingPolicy] = None,
                 market=None, fallback=None,
                 checkpoint: Optional[CheckpointPolicy] = None,
                 health: Optional[FailureDetector] = None,
                 straggler: Optional[StragglerPolicy] = None,
                 vertical=None, qos=None,
                 contention_stage_s: float = 1.0,
                 engine=None, journal: bool = True,
                 retain_traces: bool = True,
                 timeline_cap: Optional[int] = None,
                 dispatch_coalesce: float = 0.0, device="cuda"):
        if admission not in ("fifo", "priority"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        # multi-model fleets: model_id -> (cfg, params); instances whose
        # model_id is absent fall back to the default (cfg, params) pool
        self.models = dict(models or {})
        self.admission = admission
        self.batch_admit_headroom = batch_admit_headroom
        self.default_slo = default_slo
        self.rebalance_interval = rebalance_interval
        self.rebalance_ratio = rebalance_ratio
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.temperature = temperature
        self.decode_block = max(int(decode_block), 1)
        self.prefill_mode = prefill_mode
        self.dt = dt                  # control-plane evaluation interval
        self.seed = seed
        # million-request knobs: engine="sim" swaps every replica's
        # ServingEngine for the token-accounting SimEngine twin;
        # journal=False keeps only the loop's CRC digest; retain_traces=
        # False streams request metrics into bounded aggregates;
        # timeline_cap bounds the human-readable event log; and
        # dispatch_coalesce>0 batches all arrivals within that window
        # into ONE router pass (0.0 = the historical per-timestamp
        # coalescing, bit-identical to old behaviour)
        if engine == "sim":
            from repro_torch.serving.simengine import SimEngine
            engine = SimEngine
        self.engine_cls = engine
        self.timeline_cap = timeline_cap
        self.dispatch_coalesce = float(dispatch_coalesce)
        self.clock = VirtualClock()
        self.loop = EventLoop(self.clock, journal=journal)
        self.store = InMemoryStore()
        self.monitor = RateMonitor(len(fleet))
        self.router = router if router is not None else RateAwareRouter()
        self.faults = trace if trace is not None else FaultTrace(
            rebalance_lead=rebalance_lead, notice_deadline=notice_deadline)
        self.metrics = ClusterMetrics(retain_traces=retain_traces)
        # spot-market mode: every launch becomes a priced purchase on
        # the exchange; the sampled interruption time (a function of the
        # market bought) drives the SAME FaultTrace transport as
        # explicit injections, and the exchange's ledger reports savings
        # through metrics.summary().  A fallback strategy (default:
        # buy on-demand) decides where replacement capacity comes from
        # when a spot notice fires.
        self.exchange = market
        if fallback is not None and market is None:
            raise ValueError("a fallback strategy needs a market "
                             "exchange (pass market=SpotExchange(...))")
        if market is not None:
            from repro_torch.market.fallback import (OnDemandFallback,
                                                     make_fallback)
            self.fallback = make_fallback(fallback) or OnDemandFallback()
            market.bind_metrics(self.metrics)
            self.metrics.attach_ledger(market.ledger)
        else:
            self.fallback = None
        # chaos & recovery: periodic WorkUnit checkpoints, heartbeat
        # failure detection, straggler quarantine, and a cluster-wide
        # network-contention window inflating staging/heartbeat latency
        self.checkpoint = checkpoint
        self.health = health
        # vertical elasticity: a VerticalScalingPolicy recommends
        # in-place replica resizes on the control tick; a QoSPolicy
        # grades requests into Guaranteed/Burstable/BestEffort — its
        # door gate composes with the preemption policy's (either may
        # hold) and its evict_key orders shrink evictions
        self.qos = qos
        self.contention_stage_s = contention_stage_s
        self._contention: Tuple[float, float] = (1.0, 0.0)  # factor, until
        self.timeline: List[Tuple[float, str]] = []
        self._rid = itertools.count()
        self.loop.register("arrival", self._on_arrival)
        self.loop.register("spot", self._on_spot)
        self.loop.register("replica_step", self._on_replica_step)
        self.loop.register("replica_ready", self._on_replica_ready)
        self.loop.register("control", self._on_control)
        self.loop.register("dispatch", self._on_dispatch)
        self.loop.register("rebalance", self._on_rebalance)
        self.loop.register("checkpoint", self._on_checkpoint)
        self.loop.register("heartbeat", self._on_heartbeat)
        self.loop.register("health_check", self._on_health_check)
        self.loop.register("chaos_end", self._on_chaos_end)
        self.loop.register("unit_land", self._on_unit_land)
        self.faults.bind(self.loop, kind="spot")
        self.replicas: List[Replica] = []
        self._by_rid: Dict[int, Replica] = {}
        for itype in fleet:
            self.launch(itype, ready_at=0.0)
        # the control plane: three policy seams over one read-only view.
        # The autoscaler owns the scaling policy (it also validates a
        # default_itype against the fleet's pools at construction); the
        # router IS the placement policy; preemption defaults to the
        # hold-only policy parameterized by batch_admit_headroom.
        self.view = ClusterView(self)
        self.autoscaler = Autoscaler(self, scaling=scaling,
                                     **(autoscaler_kw or {}))
        self.control = ControlPlane(
            placement=self.router,
            preemption=(preemption if preemption is not None else
                        PreemptionPolicy(batch_admit_headroom)),
            scaling=self.autoscaler.policy,
            fallback=self.fallback,
            straggler=straggler,
            vertical=vertical)
        self._control_ev = None
        self._dispatch_ev = None
        self._rebalance_ev = None
        self._checkpoint_ev = None
        self._health_ev = None
        self._parked: List[WorkUnit] = []
        self._paused: List[WorkUnit] = []  # preempted, awaiting resume
        self._held: List[Request] = []   # lazily-admitted (batch) arrivals
        self._completion_hooks: List[Callable] = []

    # ------------------------------------------------------------- fleet
    def model_for(self, model_id: str) -> Tuple[ModelConfig, object]:
        return self.models.get(model_id, (self.cfg, self.params))

    def launch(self, itype: InstanceType, *, ready_at: float,
               at: Optional[float] = None, market: str = "auto",
               strategy: str = "initial") -> Replica:
        """Bring up a replica; billing starts at ``at`` (the request
        time — a pre-warmed instance costs money while it warms).

        With a market exchange attached the launch is a *purchase*:
        ``market`` picks the pool ("auto" shops the catalog by the
        exchange's pricing mode, "on_demand" buys the no-risk option, a
        name buys that market) and the sampled interruption time is
        injected into the cluster's ``FaultTrace`` — so who gets
        interrupted, and when, follows from what was bought where.
        """
        rid = next(self._rid)
        if rid >= self.monitor.n_pes:
            self.monitor.resize(rid + 1)
        mcfg, mparams = self.model_for(itype.model_id)
        rep = Replica(rid, mcfg, mparams, itype,
                      batch_size=self.batch_size, max_seq=self.max_seq,
                      temperature=self.temperature,
                      decode_block=self.decode_block,
                      prefill_mode=self.prefill_mode,
                      monitor=self.monitor, store=self.store,
                      ready_at=ready_at, seed=self.seed,
                      engine_cls=self.engine_cls, device=self.device)
        self.replicas.append(rep)
        self._by_rid[rid] = rep
        t_buy = at if at is not None else ready_at
        self.metrics.on_launch(rid, itype.name, model_id=itype.model_id,
                               cost_per_hour=itype.cost_per_hour, t=t_buy)
        if self.exchange is not None:
            rep.purchase, t_int = self.exchange.purchase(
                rid, itype, t=t_buy, market=market, strategy=strategy)
            if t_int is not None:
                self.faults.inject(t_int, rid)
            self.log(t_buy,
                     f"buy r{rid} {itype.name} @ {rep.purchase.market} "
                     f"(${rep.purchase.rate_at_buy:.2f}/h, {strategy})")
        if rep.state == ReplicaState.LAUNCHING:
            self.loop.schedule(ready_at, "replica_ready", rid=rid)
        return rep

    def retire(self, rep: Replica, now: float):
        """Terminate a replica and stop its meter."""
        rep.terminate()
        self.metrics.on_terminate(rep.rid, now)

    def replica_by_rid(self, rid: int) -> Optional[Replica]:
        return self._by_rid.get(rid)

    def rates(self) -> Dict[int, float]:
        """Measured, normalized rates keyed by replica id."""
        r = self.monitor.rates()
        return {rep.rid: float(r[rep.rid]) for rep in self.replicas
                if rep.rid < len(r)}

    def readmit(self, units: List[WorkUnit], now: float) -> bool:
        """Place packed units on the least-loaded admitting replicas.

        Returns False (and parks the units) when nobody can take them;
        they are re-admitted as soon as a replica is serving again.
        """
        if not units:
            return True
        rates = self.rates()
        # queue_work fallback: drained units only land on replicas with
        # free slots — they wait parked rather than pile onto engines
        # that are already saturated
        need_free = (self.fallback is not None
                     and self.fallback.queue_until_free)
        free = {r.rid: r.engine.free_slots for r in self.replicas}

        def key(r):
            return r.engine.backlog_tokens() / max(rates.get(r.rid, 1.0),
                                                   1e-9)
        all_placed = True
        for u in units:
            # placement never crosses model pools: a unit only fits an
            # engine built from the same (cfg, max_seq)
            survivors = [r for r in self.replicas if r.admitting
                         and r.model_id == u.request.model_id]
            if need_free:
                survivors = [r for r in survivors if free.get(r.rid, 0) > 0]
            if not survivors:
                self._parked.append(u)
                all_placed = False
                continue
            tgt = min(survivors, key=key)
            if need_free:
                free[tgt.rid] -= 1
            # a contention window inflates the staging leg: the unit is
            # in transit for the extra latency and lands via an event
            # (by then the target may have died — unit_land re-places)
            delay = (self.net_factor(now) - 1.0) * self.contention_stage_s
            if delay > 0.0:
                self.loop.schedule(now + delay, "unit_land",
                                   rid=tgt.rid, unit=u)
                self.metrics.contention_delay_s += delay
                self.log(now, f"readmit req{u.rid} -> r{tgt.rid} "
                              f"(+{delay:.3g}s contention)")
                continue
            tgt.unpack([u])
            u.record_hop(tgt.rid, now, "land")
            self._kick(tgt, now)
            self.log(now, f"readmit req{u.rid} -> r{tgt.rid}")
        return all_placed

    def log(self, t: float, msg: str):
        if (self.timeline_cap is None
                or len(self.timeline) < self.timeline_cap):
            self.timeline.append((t, msg))

    # ------------------------------------------------------------- input
    def submit(self, req: Request, at: float = 0.0):
        self.loop.schedule(at, "arrival", request=req)

    def attach_arrivals(self, process: Iterable[Tuple[float, Request]]):
        """Open-loop arrivals: schedule the process's first request; each
        arrival event then schedules the next (message-driven, no heap of
        pre-materialized arrivals)."""
        it = iter(process)
        self._schedule_next_arrival(it)

    def _schedule_next_arrival(self, it: Iterator[Tuple[float, Request]]):
        for at, req in it:
            self.loop.schedule(at, "arrival", request=req, source=it)
            return

    def attach_closed_loop(self, proc):
        """Closed-loop offered load (``ClosedLoopThinkTime``): the first
        ``n_users`` arrivals are scheduled now; every completion re-arms
        the next one after the process's think time."""
        self._completion_hooks.append(proc.on_complete)
        for at, req in proc.initial():
            self.loop.schedule(at, "arrival", request=req)

    def inject_interruption(self, t: float, replica_rid: int):
        self.faults.inject(t, replica_rid)

    # ------------------------------------------------------------- handlers
    def _on_arrival(self, ev, t: float):
        req: Request = ev.payload["request"]
        if req.slo is None:
            req.slo = self.default_slo
        req.arrival_t = t
        self.metrics.on_submit(req.rid, t, slo=req.slo.name,
                               deadline_t=req.deadline_t(),
                               model_id=req.model_id)
        # priority admission: lazily-admitted classes (batch) wait at the
        # door while the preemption policy's headroom gate says the fleet
        # is loaded, so they never crowd out latency-sensitive work;
        # everyone else enters the router queue, where an SLO-aware
        # router lets interactive requests queue-jump by (priority,
        # deadline) order
        hold = (self.admission == "priority" and req.slo.admit_lazily
                and self.control.preemption.hold(req, self.view))
        # QoS gate composes: BestEffort bursts into idle capacity only
        if not hold and self.qos is not None:
            hold = self.qos.hold(req, self.view)
        if hold:
            self._held.append(req)
            self.log(t, f"hold req{req.rid} ({req.slo.name}: no headroom)")
        else:
            self.router.submit(req)
        source = ev.payload.get("source")
        if source is not None:
            self._schedule_next_arrival(source)
        # coalesce: N same-timestamp arrivals (batch submission) trigger
        # ONE router pass, after the last of them — not N full
        # greedy_refine re-placements.  dispatch_coalesce > 0 widens the
        # window: all arrivals within it share one router pass
        if self._dispatch_ev is None:
            self._dispatch_ev = self.loop.schedule(
                t + self.dispatch_coalesce, "dispatch")

    def _on_dispatch(self, ev, t: float):
        nxt = self.loop.peek()
        if nxt is not None and nxt.kind == "arrival" and nxt.t <= t:
            # a chained arrival at this same timestamp is still in flight
            # (its schedule order interleaves with ours): defer the router
            # pass behind it rather than re-placing per arrival
            self._dispatch_ev = self.loop.schedule(t, "dispatch")
            return
        self._dispatch_ev = None
        self._dispatch(t)

    def _on_spot(self, ev, t: float):
        notice = ev.payload["notice"]
        if notice.kind in CHAOS_KINDS:
            self._on_chaos(notice, t)
        else:
            self.autoscaler.handle_spot(notice, t)
        self._dispatch(t)

    # --------------------------------------------------------------- chaos
    def net_factor(self, now: float) -> float:
        """Current network-contention multiplier on staging latency and
        heartbeat delivery (1.0 outside a contention window)."""
        factor, until = self._contention
        return factor if now < until else 1.0

    def _on_chaos(self, notice, t: float):
        rep = self.replica_by_rid(notice.target) \
            if notice.target >= 0 else None
        if self.checkpoint is not None:
            # adaptive cadence input: every chaos event is a measured
            # fault the policy may tighten the checkpoint interval for
            self.checkpoint.note_fault(t)
        if notice.kind == "hard_kill":
            if rep is None or not rep.serving:
                return
            if rep.step_event is not None:
                self.loop.cancel(rep.step_event)
                rep.step_event = None
            manifest = rep.hard_kill(t)
            # requests that had finished BEFORE the kill (surfaced by the
            # manifest's flush) were delivered — they complete, not lose
            self._harvest(rep, t)
            n_lost = sum(len(v) for v in manifest.values())
            self.metrics.on_hard_kill(rep.rid, n_lost)
            self.metrics.on_terminate(rep.rid, t)  # provider stops billing
            self.log(t, f"hard_kill r{rep.rid}: {n_lost} request(s) "
                        f"in flight, zero notice")
            # deliberately NO drain and NO readmission here: nothing
            # announced this kill, so only heartbeat silence (the
            # FailureDetector) can discover and recover the lost work
        elif notice.kind == "slowdown":
            if rep is None or not rep.serving:
                return
            rep.apply_slowdown(notice.factor, t + notice.duration)
            self.metrics.slowdowns += 1
            self.loop.schedule(t + notice.duration, "chaos_end",
                               rid=rep.rid, what="slowdown")
            self.log(t, f"slowdown r{rep.rid} x{notice.factor:g} "
                        f"for {notice.duration:g}s")
        elif notice.kind == "network_contention":
            factor = max(notice.factor, 1.0)
            until = t + notice.duration
            cur_f, cur_until = self._contention
            if t < cur_until:       # overlapping windows: worst of both
                factor, until = max(factor, cur_f), max(until, cur_until)
            self._contention = (factor, until)
            self.metrics.contention_windows += 1
            self.loop.schedule(until, "chaos_end", rid=-1,
                               what="network_contention")
            self.log(t, f"network_contention x{notice.factor:g} "
                        f"for {notice.duration:g}s")
        elif notice.kind == "endpoint_failure":
            if rep is None:
                return
            rep.endpoint.arm_failures(notice.count)
            self.metrics.endpoint_faults += 1
            self.log(t, f"endpoint_failure r{rep.rid}: next "
                        f"{notice.count} staging op(s) fail")

    def _on_chaos_end(self, ev, t: float):
        if ev.payload["what"] == "slowdown":
            rep = self.replica_by_rid(ev.payload["rid"])
            if rep is not None:
                rep.clear_slowdown(t)
                self.log(t, f"slowdown r{rep.rid} ended")
        # contention clears itself through net_factor's until-timestamp
        self._dispatch(t)

    def _on_replica_ready(self, ev, t: float):
        rep = self.replica_by_rid(ev.payload["rid"])
        if rep is not None:
            rep.maybe_ready(t)
        self._dispatch(t)

    def _on_replica_step(self, ev, t: float):
        rep = self.replica_by_rid(ev.payload["rid"])
        if rep is None:
            return
        rep.step_event = None
        if not (rep.serving and rep.has_work()):
            return                     # drained/terminated since scheduling
        emitted = rep.step_once(t)
        self.metrics.on_tokens(rep.rid, emitted, rep.last_step_cost)
        self.metrics.on_occupancy(rep.rid, rep.engine.occupancy())
        if self.qos is not None:
            # slot-seconds by QoS tier: each still-occupied slot held a
            # lane for the virtual cost of the batch just run
            for _slot, r in rep.engine.slot_requests():
                self.metrics.on_qos_slot(self.qos.qos_for(r.slo).name,
                                         rep.last_step_cost)
        done = self._harvest(rep, t)
        # the batch just run occupies [t, t + last_step_cost): the next
        # step event lands after its accounted cost
        self._kick(rep, t, delay=rep.last_step_cost)
        if done:
            self._dispatch(t)   # headroom may have opened for held work

    def _harvest(self, rep: Replica, t: float) -> List[Request]:
        """Collect completed requests from a replica: record metrics and
        fire completion hooks (closed-loop arrival re-arming).  Called
        after step events AND after any pack path that can complete a
        slot mid-poll (drain, rebalance migration, preemption)."""
        done = rep.completed + rep.engine.pop_completed()
        rep.completed = []
        for req in done:
            self.metrics.on_done(req.rid, t, len(req.out_tokens))
            for hook in self._completion_hooks:
                nxt = hook(req, t)
                if nxt is not None:
                    at, nreq = nxt
                    self.loop.schedule(max(at, t), "arrival", request=nreq)
        return done

    def _on_control(self, ev, t: float):
        self._control_ev = None
        self.autoscaler.tick(t)
        self._straggler_pass(t)
        self._vertical_pass(t)
        self._dispatch(t)

    def _on_rebalance(self, ev, t: float):
        self._rebalance_ev = None
        self._rebalance_pass(t)
        self._dispatch(t)

    # --------------------------------------------------- checkpoint events
    def _on_checkpoint(self, ev, t: float):
        """Periodic recovery checkpoint: every serving replica with live
        slots non-destructively packs them into its endpoint store.
        Pure observation — no dispatch pass, nothing moves."""
        self._checkpoint_ev = None
        for rep in self.replicas:
            if not (rep.serving and rep.engine.n_active):
                continue
            try:
                n, ckpt_s = self.checkpoint.take(rep, t)
            except EndpointUnavailable:
                self.log(t, f"checkpoint r{rep.rid} failed past retry "
                            f"budget; next pass retries")
                continue
            if n:
                self.metrics.on_checkpoint(rep.rid, n, ckpt_s)
            # the checkpoint's poll can surface just-finished slots
            self._harvest(rep, t)
        self._ensure_checkpoint(t)

    # ------------------------------------------------------ health events
    def _on_heartbeat(self, ev, t: float):
        rep = self.replica_by_rid(ev.payload["rid"])
        if rep is None or self.health is None:
            return
        rep.beat_event = None
        if rep.state is ReplicaState.TERMINATED:
            self.health.forget(rep.rid)     # retired gracefully
            return
        if rep.state is ReplicaState.DEAD:
            return   # silence — exactly the signal the detector needs
        self.health.beat(rep.rid, t,
                         progress=rep.engine.processed_tokens,
                         busy=rep.engine.n_active > 0)
        if self._pending_work():
            # contention inflates delivery: the next beat lands late,
            # which is what pushes a tight suspect_after into false
            # suspicions (cleared when the late beat arrives)
            rep.beat_event = self.loop.schedule(
                t + self.health.heartbeat_interval * self.net_factor(t),
                "heartbeat", rid=rep.rid)

    def _on_health_check(self, ev, t: float):
        self._health_ev = None
        if self.health is None:
            return
        suspects, cleared, confirmed = self.health.scan(self.replicas, t)
        for rid in suspects:
            self.log(t, f"suspect r{rid} (heartbeat silent)")
        for rid in cleared:
            self.log(t, f"clear r{rid} (heartbeat resumed)")
        for rep in confirmed:
            self._recover(rep, t)
        if self._pending_work():
            self._health_ev = self.loop.schedule(
                t + self.health.check_interval, "health_check")
        self._dispatch(t)

    def _recover(self, rep: Replica, t: float):
        """Confirmed-dead recovery: restore the last checkpoint's units
        (original request objects rewound to checkpoint progress — the
        lost tail re-decodes deterministically, so final streams stay
        bit-identical), readmit everything un-checkpointed from the
        prompt, and strike the replica from the books."""
        manifest, rep.lost = rep.lost, None
        rep.state = ReplicaState.TERMINATED
        self.health.forget(rep.rid)
        if manifest is None:
            # a false confirm (e.g. extreme contention): the replica
            # was never killed — treat as an operator-forced retirement
            self.log(t, f"confirm r{rep.rid} dead but replica alive; "
                        f"retiring it")
            self.metrics.on_terminate(rep.rid, t)
            return
        lost = {r.rid: r for r in manifest["active"]}
        lost.update({r.rid: r for r in manifest["pending"]})
        recovered_units: List[WorkUnit] = []
        restore_s, replayed = 0.0, 0
        if self.checkpoint is not None:
            units, restore_s = self.checkpoint.recover(rep)
            for u in units:
                orig = lost.pop(u.request.rid, None)
                if orig is None:
                    continue   # completed or migrated after checkpoint
                ckpt_out = list(u.snapshot.request.out_tokens)
                replayed += max(0, len(orig.out_tokens) - len(ckpt_out))
                orig.out_tokens[:] = ckpt_out    # rewind to checkpoint
                orig.done = False
                u.snapshot.request = orig  # stream continues into the
                recovered_units.append(u)  # caller's own object
        # un-checkpointed in-flight work replays from the prompt; the
        # untouched queue just re-routes
        resubmit: List[Request] = []
        for orig in lost.values():
            replayed += len(orig.out_tokens)
            orig.out_tokens[:] = []
            orig.done = False
            resubmit.append(orig)
        resubmit.extend(manifest["queued"])
        self.metrics.on_recovery(
            rep.rid, recovered=len(recovered_units) + len(resubmit),
            replayed=replayed, latency=t - (rep.killed_t or t),
            restore_s=restore_s)
        self.log(t, f"recover r{rep.rid}: {len(recovered_units)} unit(s) "
                    f"from checkpoint, {len(resubmit)} from prompt, "
                    f"{replayed} token(s) replayed")
        if recovered_units:
            self.readmit(recovered_units, t)
        for req in resubmit:
            self.router.submit(req)

    # ------------------------------------------------ straggler mitigation
    def _straggler_pass(self, now: float):
        """Execute the straggler policy's quarantine/release orders:
        quarantined replicas stop admitting (they finish what they
        hold), and their urgent slots migrate to healthy peers."""
        pol = self.control.straggler
        if pol is None:
            return
        for order in pol.orders(self.view, now):
            rep = self.replica_by_rid(order.rid)
            if rep is None or not rep.serving:
                continue
            if isinstance(order, QuarantineOrder):
                rep.quarantined = True
                rep.quarantined_t = now
                self.metrics.quarantines += 1
                self.log(now, f"quarantine r{rep.rid} (straggler)")
                if order.slots:
                    units, _times = rep.pack_slots(list(order.slots))
                    self._harvest(rep, now)
                    for u in units:
                        u.packed_t = now
                        u.record_hop(rep.rid, now, "straggler")
                        self.metrics.on_migration(u.rid)
                    self.metrics.rebalance_migrations += len(units)
                    self.readmit(units, now)
            else:
                rep.quarantined = False
                self.log(now, f"release r{rep.rid} (rate recovered)")

    # ---------------------------------------------- vertical elasticity
    def _vertical_pass(self, now: float):
        """Execute the vertical policy's in-place resize orders.

        A grow just rebuilds the replica's geometry (surviving streams
        continue bit-identically through the canonical snapshot path);
        a shrink may evict slots — those units park exactly like
        preempted ones (the preemption policy's resume liveness
        fallback guarantees they re-admit), so no WorkUnit is ever lost
        to a resize.  Eviction order is the QoS policy's when one is
        attached (BestEffort first)."""
        pol = self.control.vertical
        if pol is None:
            return
        evict_key = self.qos.evict_key if self.qos is not None else None
        for order in pol.decide(self.view, now):
            rep = self.replica_by_rid(order.rid)
            if rep is None or not rep.serving:
                continue
            old_batch = rep.engine.batch
            units, (ckpt_s, restore_s) = rep.resize(
                batch_size=order.batch_size,
                decode_block=order.decode_block,
                kv_pool_blocks=order.kv_pool_blocks,
                evict_key=evict_key)
            self._harvest(rep, now)   # the pack poll may complete slots
            new_batch = rep.engine.batch
            self.metrics.on_resize(rep.rid, old_batch, new_batch,
                                   evicted=len(units),
                                   stage_s=ckpt_s + restore_s)
            for u in units:
                u.packed_t = now
                u.record_hop(rep.rid, now, "resize")
                self.log(now, f"evict req{u.rid} ({u.slo_name}) "
                              f"by resize r{rep.rid}")
            self._paused.extend(units)
            self.log(now, f"resize r{rep.rid} {old_batch}->{new_batch} "
                          f"lanes ({order.reason})")
            self._kick(rep, now)

    def _on_unit_land(self, ev, t: float):
        """Contention-delayed unit landing (the in-transit leg of a
        migration under an inflated-staging-latency window)."""
        unit: WorkUnit = ev.payload["unit"]
        rep = self.replica_by_rid(ev.payload["rid"])
        if rep is None or not rep.serving:
            self.readmit([unit], t)   # target vanished in transit
            return
        rep.unpack([unit])
        unit.record_hop(rep.rid, t, "land")
        self._kick(rep, t)
        self._dispatch(t)

    # ------------------------------------------------------------- driving
    def _kick(self, rep: Replica, now: float,
              delay: Optional[float] = None):
        """Schedule ``rep``'s next engine step unless one is pending.

        ``delay`` is the virtual cost of the batch that just ran (from
        ``step_once``); a first kick after idle uses one step interval
        as admission latency."""
        if rep.step_event is not None:
            return
        if not (rep.serving and rep.has_work()):
            return
        if delay is None:
            delay = rep.step_interval
        rep.step_event = self.loop.schedule(
            now + delay, "replica_step", rid=rep.rid)

    def _dispatch(self, now: float):
        """One control-plane pass; runs after any state-changing event.

        Mechanism only — every decision is delegated: parked units
        re-admit, the preemption policy rules on held arrivals, the
        placement policy routes, then the preemption policy may pause
        saturated batch work / resume parked units.
        """
        self._unpark(now)
        self._admit_held(now)
        for rep in self.control.placement.place(self.view, now):
            self._kick(rep, now)
        self._preemption_pass(now)
        self._ensure_control(now)
        self._ensure_rebalance(now)
        self._ensure_checkpoint(now)
        self._ensure_health(now)

    def _ensure_control(self, now: float):
        if self._control_ev is None and self._pending_work():
            self._control_ev = self.loop.schedule(now + self.dt, "control")

    def _ensure_checkpoint(self, now: float):
        """Keep the recovery-checkpoint cadence alive while any serving
        replica holds in-flight slots (an idle fleet has nothing worth
        checkpointing, and the loop must be able to drain)."""
        if (self.checkpoint is not None
                and self._checkpoint_ev is None
                and any(r.serving and r.engine.n_active
                        for r in self.replicas)):
            self._checkpoint_ev = self.loop.schedule(
                now + self.checkpoint.next_interval(self.replicas, now),
                "checkpoint")

    def _ensure_health(self, now: float):
        """Arm heartbeat chains for live replicas that lack one and the
        recurring health-check scan.  Both are gated on pending work so
        the event loop drains once the fleet goes (and stays) idle."""
        if self.health is None or not self._pending_work():
            return
        for rep in self.replicas:
            if (rep.state in (ReplicaState.RUNNING, ReplicaState.AT_RISK)
                    and rep.beat_event is None):
                # arming the chain records a birth beat: the replica is
                # demonstrably alive right now, and without it a kill
                # landing before the first scheduled heartbeat would
                # leave the replica unmonitored — and unrecovered —
                # forever
                self.health.beat(rep.rid, now)
                rep.beat_event = self.loop.schedule(
                    now + self.health.heartbeat_interval
                    * self.net_factor(now),
                    "heartbeat", rid=rep.rid)
        if self._health_ev is None:
            self._health_ev = self.loop.schedule(
                now + self.health.check_interval, "health_check")

    def _unrecovered(self) -> bool:
        """True while a hard-killed replica still holds a lost-work
        manifest nobody has recovered."""
        return any(r.state is ReplicaState.DEAD and r.lost is not None
                   for r in self.replicas)

    def _ensure_rebalance(self, now: float):
        """Keep the recurring mid-stream-migration pass alive while any
        replica holds in-flight slots (queue-only backlog is the
        router's job, not the rebalancer's)."""
        if (self.rebalance_interval is not None
                and self._rebalance_ev is None
                and any(r.serving and r.engine.n_active
                        for r in self.replicas)):
            self._rebalance_ev = self.loop.schedule(
                now + self.rebalance_interval, "rebalance")

    def _pending_work(self) -> bool:
        # an unrecovered hard kill counts as pending work only when a
        # FailureDetector is attached: with recovery ON the health loop
        # keeps ticking until the manifest is recovered; with recovery
        # OFF the loop drains and the lost requests stay demonstrably
        # lost (the A/B the chaos benchmark measures)
        return (bool(self.router.queue) or bool(self._parked)
                or bool(self._held) or bool(self._paused)
                or any(r.serving and r.has_work() for r in self.replicas)
                or (self.health is not None and self._unrecovered()))

    def _unpark(self, now: float):
        if not self._parked:
            return
        parked, self._parked = self._parked, []
        self.readmit(parked, now)

    # --------------------------------------------------------- admission
    def _admit_held(self, now: float):
        if not self._held:
            return
        admit, self._held = self.control.preemption.admit_held(
            self._held, self.view)
        if self.qos is not None and admit:
            # both gates must open: a request the preemption policy
            # would admit stays held while its QoS tier has no idle
            # capacity to burst into
            admit, still = self.qos.admit_held(admit, self.view)
            self._held.extend(still)
        for req in admit:
            self.router.submit(req)
            self.log(now, f"admit req{req.rid} (headroom opened)")

    # -------------------------------------------------------- preemption
    def _preemption_pass(self, now: float):
        """Execute the preemption policy's pause/resume orders through
        the WorkUnit verbs.  Paused units park on the cluster (their
        snapshot retained, slot freed); resumes re-admit them with
        restore-queue priority, so the stream continues bit-identically
        ahead of fresh arrivals."""
        pol = self.control.preemption
        for order in pol.preempt(self.view, now):
            rep = self.replica_by_rid(order.rid)
            if rep is None or not rep.serving:
                continue
            units, (ckpt_s, restore_s) = rep.preempt(order.slots)
            self._harvest(rep, now)   # the pack poll may complete slots
            if units:                 # one staging round trip per order
                self.metrics.preempt_stage_s += ckpt_s + restore_s
            for u in units:
                u.packed_t = now
                u.record_hop(rep.rid, now, "preempt")
                self.metrics.on_preempt(u.rid)
                self.log(now, f"preempt req{u.rid} ({u.slo_name}) "
                              f"r{rep.rid} slot freed")
            self._paused.extend(units)
            self._kick(rep, now)
        if not self._paused:
            return
        for order in pol.resume(self.view, now):
            rep = self.replica_by_rid(order.rid)
            if rep is None or not rep.admitting:
                continue
            units = [u for u in order.units if u in self._paused]
            if not units:
                continue
            for u in units:
                self._paused.remove(u)
                u.record_hop(rep.rid, now, "resume")
                self.metrics.on_resume(u.rid)
                self.log(now, f"resume req{u.rid} -> r{rep.rid}")
            rep.resume(units)
            self._kick(rep, now)

    # --------------------------------------------------------- rebalance
    def _rebalance_pass(self, now: float):
        """Execute the placement policy's mid-stream migration plans:
        pack the chosen slot, stage it through the source's endpoint,
        unpack on the destination."""
        plans = self.control.placement.rebalance(
            self.view, now, ratio=self.rebalance_ratio)
        for plan in plans:
            src = self.replica_by_rid(plan.src)
            dst = self.replica_by_rid(plan.dst)
            if src is None or dst is None or not dst.admitting:
                continue
            units, _times = src.pack_slots([plan.slot])
            self._harvest(src, now)   # the pack poll may complete slots
            if not units:
                continue
            for u in units:
                u.packed_t = now
                u.record_hop(src.rid, now, "rebalance")
                self.metrics.on_migration(u.rid)
            self.metrics.rebalance_migrations += len(units)
            dst.unpack(units)
            for u in units:
                u.record_hop(dst.rid, now, "land")
            self.log(now, f"rebalance req{units[0].rid} "
                          f"r{src.rid} -> r{dst.rid}")
            self._kick(dst, now)

    def run(self, *, max_time: float = 100_000.0,
            max_events: int = 10_000_000) -> Dict[str, float]:
        """Dispatch events until the loop drains (or ``max_time``).

        Exhausting ``max_events`` with live work still due raises
        (loop-level): a truncated sim must not report partial metrics
        as if complete."""
        self.loop.run(until=max_time, max_events=max_events)
        # endpoint retry accounting lives on the endpoints themselves;
        # fold it into the fleet summary once the run is over
        self.metrics.endpoint_retries = sum(
            rep.endpoint.retries for rep in self.replicas)
        self.metrics.retry_backoff_s = sum(
            rep.endpoint.backoff_s for rep in self.replicas)
        return self.metrics.summary(self.clock.now())
