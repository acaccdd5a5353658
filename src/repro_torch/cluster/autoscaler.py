"""Spot-lifecycle handling + elastic scaling *mechanism*.

The decisions live in a pluggable ``ScalingPolicy``
(``repro.cluster.control``): when a pool grows or shrinks, and which
``InstanceType`` to buy (``BacklogScaling`` = thresholds,
``CostAwareScaling`` = price-performance over a catalog).  This class
only executes:

* spot events from the cluster's bound ``FaultTrace`` — on a *rebalance
  recommendation* it pre-warms the policy-chosen replacement (the
  paper's Mode C: replacements are requested at the recommendation,
  long before the 2-minute notice); on the *interruption notice* it
  drains the doomed replica: every in-flight slot is packed into
  ``WorkUnit``s (staged through the replica's ``MigrationEndpoint``)
  and re-admitted onto the healthiest survivors; queued requests go
  back to the router.  Zero requests are dropped and no decoded token
  is recomputed.
* ``ScaleDecision``s from ``policy.decide`` — launches are billed from
  the decision time; retirements drain losslessly, then terminate.

A ``default_itype`` that serves NO pool of the fleet is a configuration
error and is rejected at construction; a default that serves a
*different* pool than the one scaling up is substituted by the pool's
own type — and the substitution is logged on the cluster timeline, never
silent (``ScalingPolicy.select_itype``).

Port of ``repro.cluster.autoscaler``; ``SpotNotice`` comes from the
port's ``runtime`` (the reference's ``core.cloud`` re-exports it).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.runtime import SpotNotice

from repro_torch.cluster.control import BacklogScaling, ScalingPolicy
from repro_torch.cluster.metrics import DrainRecord
from repro_torch.cluster.replica import Replica, ReplicaState


class Autoscaler:
    def __init__(self, cluster, *, replacement_latency: float = 90.0,
                 scaling: Optional[ScalingPolicy] = None, **policy_kw):
        self.cluster = cluster
        self.replacement_latency = replacement_latency
        if scaling is not None and policy_kw:
            raise ValueError(
                f"an explicit scaling policy carries its own thresholds; "
                f"drop the conflicting autoscaler kwargs "
                f"{sorted(policy_kw)} or configure the policy instead")
        self.policy = scaling if scaling is not None \
            else BacklogScaling(**policy_kw)
        default = self.policy.default_itype
        if default is not None:
            pools = ({it.model_id for it in
                      (r.itype for r in cluster.replicas)}
                     | set(cluster.models))
            if default.model_id not in pools:
                raise ValueError(
                    f"default_itype {default.name!r} serves model pool "
                    f"{default.model_id!r}, which no fleet instance or "
                    f"configured model provides (pools: {sorted(pools)})")

    # ------------------------------------------------------------- events
    def handle_spot(self, ev: SpotNotice, now: float):
        rep = self.cluster.replica_by_rid(ev.target)
        if rep is None or rep.state in (ReplicaState.TERMINATED,
                                        ReplicaState.DEAD):
            return   # gone (or silently dead: a notice can't revive it)
        if ev.kind == "rebalance_recommendation":
            if rep.serving:
                rep.state = ReplicaState.AT_RISK
                fb = self.cluster.fallback
                if fb is not None:
                    # market mode: the fallback strategy decides where
                    # replacement capacity comes from — which hardware,
                    # which market, or none at all (queue_work /
                    # scale_down ride out the loss on survivors)
                    order = fb.replacement(self.cluster.view, rep,
                                           self.cluster.exchange, now)
                    if order is None:
                        self.cluster.log(
                            now, f"rebalance_recommendation r{rep.rid} "
                                 f"fallback={fb.name}: no replacement")
                    else:
                        new = self.cluster.launch(
                            order.itype,
                            ready_at=now + self.replacement_latency,
                            at=now, market=order.market, strategy=fb.name)
                        self.cluster.log(
                            now, f"rebalance_recommendation r{rep.rid} "
                                 f"fallback={fb.name} prewarm r{new.rid} "
                                 f"({order.itype.name} @ {order.market})")
                else:
                    # Mode C: request the replacement NOW, rescale later
                    # — the scaling policy chooses the instance type
                    # (cost-aware policies may shop the catalog instead
                    # of replacing like-for-like)
                    itype = self.policy.replacement(self.cluster.view, rep)
                    new = self.cluster.launch(
                        itype, ready_at=now + self.replacement_latency,
                        at=now)
                    self.cluster.log(now,
                                     f"rebalance_recommendation r{rep.rid} "
                                     f"prewarm r{new.rid} ({itype.name})")
        elif ev.kind == "interruption_notice":
            self.cluster.log(now, f"interruption_notice r{rep.rid}")
            self.drain(rep, now, reason="interruption")
        elif ev.kind == "terminate":
            self.cluster.retire(rep, now)
            self.cluster.log(now, f"terminated r{rep.rid}")

    def drain(self, rep: Replica, now: float,
              reason: str = "interruption"):
        """Pack the doomed replica's slots; re-admit them elsewhere.

        ``reason`` stamps unit provenance and the savings ledger:
        "interruption" = spot notice, "scale_down" = policy retirement.
        """
        self.cluster.loop.cancel(rep.step_event)   # no step after the drain
        rep.step_event = None
        units, queued, (ckpt_s, restore_s) = rep.drain_units()
        # the drain's pack poll may discover just-finished slots: they
        # complete here, not migrate (the replica never steps again)
        self.cluster._harvest(rep, now)
        metrics = self.cluster.metrics
        metrics.drains.append(DrainRecord(
            t=now, replica=rep.rid, slots_migrated=len(units),
            queued_requeued=len(queued), checkpoint_s=ckpt_s,
            restore_s=restore_s, endpoint=rep.endpoint.kind))
        if reason == "interruption" and metrics.ledger is not None:
            metrics.ledger.on_interruption(rep.rid, now,
                                           overhead_s=ckpt_s + restore_s)
        for u in units:
            u.packed_t = now
            u.record_hop(rep.rid, now, reason)
            metrics.on_migration(u.rid)
        if queued:
            self.cluster.router.requeue(queued)
        # least-loaded-first (rate-scaled) re-admission; parked if nobody
        # is serving yet (re-admitted once a replacement comes up)
        self.cluster.readmit(units, now)

    # ------------------------------------------------------------- load
    def tick(self, now: float):
        """Evaluate every model pool independently (replicas, backlog,
        and SLO pressure never leak across pools) and execute the
        policy's decisions."""
        cl = self.cluster
        for model_id in cl.view.pools():
            decision = self.policy.decide(cl.view, model_id, now)
            if decision is None:
                continue
            if decision.launch is not None:
                new = cl.launch(decision.launch,
                                ready_at=now + self.replacement_latency,
                                at=now, strategy="scale_up")
                cl.log(now, f"scale_up r{new.rid} ({decision.launch.name}) "
                            f"pool={model_id} {decision.reason}")
            if decision.retire is not None:
                victim = cl.replica_by_rid(decision.retire)
                if victim is not None and victim.serving:
                    self.drain(victim, now, reason="scale_down")
                    cl.retire(victim, now)
                    cl.log(now, f"scale_down r{victim.rid} "
                                f"pool={model_id} ({decision.reason})")
