"""Cluster observability: request traces, fleet summaries.

Everything is keyed off *virtual* time so cluster runs are deterministic
and reproducible on any host; only checkpoint/restore stage timings (from
the ``InMemoryStore`` timers) are real wall-clock measurements.  The
clock itself is the shared ``repro.runtime.VirtualClock`` (re-exported
here for back-compat).

Port of ``repro.cluster.metrics`` (imports redirected).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.runtime import VirtualClock  # noqa: F401  (re-export)


class _LatencyHist:
    """Log-spaced latency histogram: O(1)-memory approximate percentiles
    for streaming (``retain_traces=False``) runs.  320 geometric buckets
    over [1e-4, 1e6] virtual seconds give ~7.5% relative resolution —
    plenty for a p99 floor — without holding one latency per request."""

    _EDGES = np.geomspace(1e-4, 1e6, 321)

    def __init__(self):
        self.counts = np.zeros(self._EDGES.size + 1, dtype=np.int64)
        self.n = 0
        self.max_seen = 0.0

    def add(self, lat: float):
        self.counts[int(np.searchsorted(self._EDGES, lat))] += 1
        self.n += 1
        if lat > self.max_seen:
            self.max_seen = lat

    def percentile(self, q: float) -> float:
        if self.n == 0:
            return 0.0
        target = q / 100.0 * self.n
        cum = 0
        for idx in range(self.counts.size):
            cum += int(self.counts[idx])
            if cum >= target:
                if idx == 0:
                    return float(min(self._EDGES[0], self.max_seen))
                if idx >= self._EDGES.size:
                    return self.max_seen
                # geometric bucket midpoint
                return float(np.sqrt(self._EDGES[idx - 1]
                                     * self._EDGES[idx]))
        return self.max_seen


@dataclasses.dataclass
class _ClassAgg:
    """Streaming per-(SLO, pool) completion aggregate."""
    completed: int = 0
    met: int = 0                 # completed at or before the deadline
    finite_misses: int = 0       # completed late against a finite deadline
    tokens: int = 0


@dataclasses.dataclass
class RequestTrace:
    rid: int
    arrival_t: float
    done_t: Optional[float] = None
    tokens: int = 0
    migrations: int = 0          # times this request was migrated
    preemptions: int = 0         # times this request was paused mid-stream
    slo: str = "standard"        # SLO class name
    deadline_t: float = float("inf")   # absolute completion deadline
    model_id: str = "default"

    @property
    def latency(self) -> Optional[float]:
        return None if self.done_t is None else self.done_t - self.arrival_t

    @property
    def met_deadline(self) -> bool:
        """Completed at or before the deadline (incomplete = missed)."""
        return self.done_t is not None and self.done_t <= self.deadline_t


@dataclasses.dataclass
class ReplicaStats:
    rid: int
    itype: str
    tokens: int = 0
    busy_s: float = 0.0          # virtual seconds with work in the engine
    model_id: str = "default"    # pool this replica serves
    cost_per_hour: float = 0.0   # dollars per virtual hour alive
    launched_t: float = 0.0      # billing start (launch request time)
    terminated_t: Optional[float] = None   # billing stop (None = alive)
    # engine cache occupancy (high-water): concurrent occupied slots,
    # and — paged-cache engines only — blocks in use vs pool size
    peak_slots: int = 0
    peak_blocks: int = 0
    pool_blocks: int = 0

    def dollar_cost(self, horizon: float) -> float:
        """Dollars accrued by ``horizon`` (virtual seconds) — a live
        replica bills through the horizon, a retired one to its end."""
        end = self.terminated_t if self.terminated_t is not None \
            else horizon
        return max(end - self.launched_t, 0.0) / 3600.0 \
            * self.cost_per_hour


@dataclasses.dataclass
class DrainRecord:
    t: float
    replica: int
    slots_migrated: int
    queued_requeued: int
    checkpoint_s: float          # real (measured) store stage seconds
    restore_s: float = 0.0
    endpoint: str = "host"       # MigrationEndpoint kind (host | device)


class ClusterMetrics:
    """Fleet observability.

    Two retention modes:

    * ``retain_traces=True`` (default): one ``RequestTrace`` per request
      for the whole run — exact percentiles, windowed attainment.
    * ``retain_traces=False`` (million-request runs): only *live*
      requests hold a trace; completions fold into per-(SLO, pool)
      counters and log-spaced latency histograms, so memory is bounded
      by the number of in-flight requests, not the request count.
      Percentiles become histogram-approximate (~7.5% relative) and
      ``class_attainment``'s ``since``/``until`` window only scopes the
      still-live population (completed requests aggregate globally).
    """

    def __init__(self, retain_traces: bool = True):
        self.retain_traces = retain_traces
        self.traces: Dict[int, RequestTrace] = {}
        # streaming aggregates (only fed when retain_traces=False)
        self._classes: Set[str] = set()
        self._submitted = 0
        self._done_count = 0
        self._done_tokens = 0
        self._max_done_t = 0.0
        self._hist = _LatencyHist()
        self._slo_hist: Dict[str, _LatencyHist] = {}
        self._agg: Dict[Tuple[str, str], _ClassAgg] = {}
        self.replicas: Dict[int, ReplicaStats] = {}
        self.drains: List[DrainRecord] = []
        self.rebalance_migrations = 0    # mid-stream (load) slot moves
        self.preemptions = 0             # slots paused by the preemptor
        self.resumes = 0                 # paused units re-admitted
        self.preempt_stage_s = 0.0       # real store seconds spent pausing
        self.ledger = None               # SavingsLedger (market mode only)
        # chaos & recovery (zero-filled in summary() so fault-free
        # scenarios emit the same stable schema)
        self.hard_kills = 0              # zero-notice terminations
        self.requests_lost = 0           # in-flight on a dead replica,
                                         # not (yet) recovered
        self.requests_recovered = 0      # restored from checkpoint or
                                         # readmitted from the prompt
        self.recoveries = 0              # confirmed-dead recovery passes
        self.replayed_tokens = 0         # decoded tokens lost + redone
        self.recovery_latency_s = 0.0    # kill -> confirmed, summed
        self.recovery_restore_s = 0.0    # real store restore seconds
        self.checkpoints = 0             # checkpoint passes that staged
        self.checkpointed_units = 0      # slots captured across passes
        self.checkpoint_stage_s = 0.0    # real store checkpoint seconds
        self.slowdowns = 0               # slowdown windows applied
        self.contention_windows = 0      # network-contention windows
        self.contention_delay_s = 0.0    # virtual staging delay added
        self.endpoint_faults = 0         # endpoint_failure faults armed
        self.endpoint_retries = 0        # staging ops that retried
        self.retry_backoff_s = 0.0       # accounted retry backoff
        self.quarantines = 0             # straggler quarantine orders
        # vertical elasticity & QoS (zero-filled in summary() like the
        # chaos block, so horizontal-only runs keep the same schema)
        self.vertical_grows = 0          # in-place lane-count increases
        self.vertical_shrinks = 0        # in-place lane-count decreases
        self.vertical_evictions = 0      # slots displaced by a shrink
        self.resize_stage_s = 0.0        # real pack/stage seconds spent
        self.qos_slot_seconds: Dict[str, float] = {}   # tier -> slot-s

    def attach_ledger(self, ledger):
        """Market mode: the exchange's ``SavingsLedger`` reports savings
        vs all-on-demand (with by-market / by-strategy breakdowns)
        through ``summary()``, and terminations stamp purchase ends."""
        self.ledger = ledger

    # ------------------------------------------------------------ request
    def on_submit(self, rid: int, now: float, *, slo: str = "standard",
                  deadline_t: float = float("inf"),
                  model_id: str = "default"):
        self._submitted += 1
        self._classes.add(slo)
        self.traces[rid] = RequestTrace(rid, now, slo=slo,
                                        deadline_t=deadline_t,
                                        model_id=model_id)

    def on_done(self, rid: int, now: float, tokens: int):
        tr = self.traces[rid]
        tr.done_t = now
        tr.tokens = tokens
        if self.retain_traces:
            return
        # streaming: fold the completion into the aggregates and drop
        # the trace — memory stays bounded by in-flight requests
        self._done_count += 1
        self._done_tokens += tokens
        if now > self._max_done_t:
            self._max_done_t = now
        lat = now - tr.arrival_t
        self._hist.add(lat)
        self._slo_hist.setdefault(tr.slo, _LatencyHist()).add(lat)
        agg = self._agg.setdefault((tr.slo, tr.model_id), _ClassAgg())
        agg.completed += 1
        agg.tokens += tokens
        if tr.met_deadline:
            agg.met += 1
        elif np.isfinite(tr.deadline_t):
            agg.finite_misses += 1
        del self.traces[rid]

    def on_migration(self, rid: int):
        if rid in self.traces:
            self.traces[rid].migrations += 1

    def on_preempt(self, rid: int):
        self.preemptions += 1
        if rid in self.traces:
            self.traces[rid].preemptions += 1

    def on_resume(self, rid: int):
        self.resumes += 1

    # ---------------------------------------------------- chaos/recovery
    def on_hard_kill(self, rid: int, n_lost: int):
        self.hard_kills += 1
        self.requests_lost += n_lost

    def on_recovery(self, rid: int, *, recovered: int, replayed: int,
                    latency: float, restore_s: float):
        self.recoveries += 1
        self.requests_recovered += recovered
        self.requests_lost = max(0, self.requests_lost - recovered)
        self.replayed_tokens += replayed
        self.recovery_latency_s += latency
        self.recovery_restore_s += restore_s

    def on_checkpoint(self, rid: int, units: int, ckpt_s: float):
        self.checkpoints += 1
        self.checkpointed_units += units
        self.checkpoint_stage_s += ckpt_s

    # ------------------------------------------------------ vertical/QoS
    def on_resize(self, rid: int, old_batch: int, new_batch: int, *,
                  evicted: int, stage_s: float):
        """One executed ``ResizeOrder``: grow or shrink by lane delta,
        plus the slots it displaced and the real staging seconds."""
        if new_batch > old_batch:
            self.vertical_grows += 1
        elif new_batch < old_batch:
            self.vertical_shrinks += 1
        self.vertical_evictions += evicted
        self.resize_stage_s += stage_s

    def on_qos_slot(self, tier: str, seconds: float):
        """Accumulate slot-seconds of lane occupancy for a QoS tier."""
        self.qos_slot_seconds[tier] = (
            self.qos_slot_seconds.get(tier, 0.0) + seconds)

    # ------------------------------------------------------------ replica
    def on_launch(self, rid: int, itype: str, *,
                  model_id: str = "default", cost_per_hour: float = 0.0,
                  t: float = 0.0):
        """Start a replica's meter: billing runs from the launch request
        until termination (or the summary horizon while alive)."""
        if rid not in self.replicas:
            self.replicas[rid] = ReplicaStats(
                rid, itype, model_id=model_id,
                cost_per_hour=cost_per_hour, launched_t=t)

    def on_terminate(self, rid: int, now: float):
        st = self.replicas.get(rid)
        if st is not None and st.terminated_t is None:
            st.terminated_t = now
        if self.ledger is not None:
            self.ledger.on_terminate(rid, now)

    def on_tokens(self, rid: int, tokens: int, busy_s: float):
        st = self.replicas[rid]
        st.tokens += tokens
        st.busy_s += busy_s

    def on_occupancy(self, rid: int, occ: Dict[str, int]):
        """Fold an engine ``occupancy()`` sample into the replica's
        high-water marks (slots always; blocks for paged caches)."""
        st = self.replicas.get(rid)
        if st is None:
            return
        st.peak_slots = max(st.peak_slots,
                            int(occ.get("max_concurrent_slots", 0)))
        st.peak_blocks = max(st.peak_blocks,
                             int(occ.get("peak_blocks_in_use", 0)))
        st.pool_blocks = max(st.pool_blocks,
                             int(occ.get("pool_blocks", 0)))

    # --------------------------------------------------------------- cost
    def pool_dollar_cost(self, horizon: float) -> Dict[str, float]:
        """Per-model-pool fleet dollars accrued by ``horizon``."""
        out: Dict[str, float] = {}
        for st in self.replicas.values():
            out[st.model_id] = out.get(st.model_id, 0.0) \
                + st.dollar_cost(horizon)
        return out

    def fleet_dollar_cost(self, horizon: float) -> float:
        return sum(self.pool_dollar_cost(horizon).values())

    # ------------------------------------------------------------ summary
    def latencies(self, slo: Optional[str] = None) -> np.ndarray:
        return np.asarray([t.latency for t in self.traces.values()
                           if t.latency is not None
                           and (slo is None or t.slo == slo)],
                          dtype=np.float64)

    def class_attainment(self, slo: str, *, model_id: Optional[str] = None,
                         since: float = -np.inf,
                         until: float = np.inf) -> Optional[float]:
        """Fraction of a class's requests that met their deadline.

        Scope: requests ARRIVED in [since, until] (so a truncated run
        counts still-running late requests as misses, and the autoscaler
        can ask about a recent window).  None when the class saw no
        traffic in the window.
        """
        pop = [t for t in self.traces.values()
               if t.slo == slo and since <= t.arrival_t <= until
               and (model_id is None or t.model_id == model_id)]
        if self.retain_traces:
            if not pop:
                return None
            return sum(t.met_deadline for t in pop) / len(pop)
        # streaming: completed requests live only in the aggregates,
        # which carry no arrival time — the window scopes just the
        # still-live population (all live requests count as misses)
        completed = met = 0
        for (s, m), agg in self._agg.items():
            if s == slo and (model_id is None or m == model_id):
                completed += agg.completed
                met += agg.met
        if completed + len(pop) == 0:
            return None
        return met / (completed + len(pop))

    def slo_classes(self) -> List[str]:
        if self.retain_traces:
            return sorted({t.slo for t in self.traces.values()})
        return sorted(self._classes)

    def overdue(self, now: float,
                model_id: Optional[str] = None) -> Dict[str, int]:
        """Per-class count of live requests already past their deadline.

        The autoscaler's SLO-attainment signal: an overdue-but-running
        request is a *decided* miss (it cannot un-miss), so a nonzero
        count means the pool is under-provisioned for that class right
        now — no completion statistics needed.
        """
        out: Dict[str, int] = {}
        for t in self.traces.values():
            if (t.done_t is None and t.deadline_t < now
                    and (model_id is None or t.model_id == model_id)):
                out[t.slo] = out.get(t.slo, 0) + 1
        return out

    def summary(self, now: float) -> Dict[str, float]:
        total_tokens = sum(s.tokens for s in self.replicas.values())
        # horizon = last request completion, NOT the loop's last event —
        # trailing bookkeeping events (a pre-warmed replica coming up, a
        # stale step) must not dilute or equalize throughput.  tok_per_s
        # pairs that horizon with the tokens of *completed* requests so a
        # max_time-truncated run can't overstate throughput (on a fully
        # drained run the two token counts coincide).
        if self.retain_traces:
            lat = self.latencies()
            done = int(sum(t.done_t is not None
                           for t in self.traces.values()))
            done_ts = [t.done_t for t in self.traces.values()
                       if t.done_t is not None]
            done_tokens = sum(t.tokens for t in self.traces.values()
                              if t.done_t is not None)
            now = max(done_ts) if done_ts else now
            submitted = len(self.traces)
            p50 = float(np.percentile(lat, 50)) if lat.size else 0.0
            p99 = float(np.percentile(lat, 99)) if lat.size else 0.0
            lat_max = float(lat.max()) if lat.size else 0.0
        else:
            done = self._done_count
            done_tokens = self._done_tokens
            submitted = self._submitted
            if done:
                now = self._max_done_t
            p50 = self._hist.percentile(50)
            p99 = self._hist.percentile(99)
            lat_max = self._hist.max_seen
        out = {
            "virtual_seconds": now,
            "submitted": submitted,
            "completed": done,
            "dropped": submitted - done,
            "total_tokens": total_tokens,
            "tok_per_s": done_tokens / max(now, 1e-9),
            "p50_latency": p50,
            "p99_latency": p99,
            "max_latency": lat_max,
            "migrated_slots": sum(d.slots_migrated for d in self.drains),
            "drains": len(self.drains),
            "rebalance_migrations": self.rebalance_migrations,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "preempt_stage_s": self.preempt_stage_s,
            "interruption_overhead_s": sum(
                d.checkpoint_s + d.restore_s for d in self.drains),
            # fleet dollars through the completion horizon (per-pool
            # figures follow; single-pool fleets just get one entry)
            "fleet_dollar_cost": self.fleet_dollar_cost(now),
            # cache-occupancy high-water across the fleet: most slots any
            # replica ran concurrently, and (paged engines) the fullest
            # any block pool got, as a fraction
            "max_concurrent_slots": max(
                (s.peak_slots for s in self.replicas.values()), default=0),
            "peak_block_occupancy": max(
                (s.peak_blocks / s.pool_blocks
                 for s in self.replicas.values() if s.pool_blocks),
                default=0.0),
            # chaos & recovery — always emitted (zero-filled) so
            # fault-free scenarios keep a stable schema
            "hard_kills": self.hard_kills,
            "requests_lost": self.requests_lost,
            "requests_recovered": self.requests_recovered,
            "recoveries": self.recoveries,
            "replayed_tokens": self.replayed_tokens,
            "recovery_latency_s": self.recovery_latency_s,
            "recovery_restore_s": self.recovery_restore_s,
            "checkpoints": self.checkpoints,
            "checkpointed_units": self.checkpointed_units,
            "checkpoint_stage_s": self.checkpoint_stage_s,
            "slowdowns": self.slowdowns,
            "contention_windows": self.contention_windows,
            "contention_delay_s": self.contention_delay_s,
            "endpoint_faults": self.endpoint_faults,
            "endpoint_retries": self.endpoint_retries,
            "retry_backoff_s": self.retry_backoff_s,
            "quarantines": self.quarantines,
            # vertical elasticity & QoS — always emitted (zero-filled)
            # so horizontal-only scenarios keep a stable schema
            "vertical_grows": self.vertical_grows,
            "vertical_shrinks": self.vertical_shrinks,
            "vertical_evictions": self.vertical_evictions,
            "resize_stage_s": self.resize_stage_s,
            "qos_guaranteed_slot_s": self.qos_slot_seconds.get(
                "guaranteed", 0.0),
            "qos_burstable_slot_s": self.qos_slot_seconds.get(
                "burstable", 0.0),
            "qos_best_effort_slot_s": self.qos_slot_seconds.get(
                "best_effort", 0.0),
        }
        for pool, cost in sorted(self.pool_dollar_cost(now).items()):
            out[f"dollar_cost_{pool}"] = cost
        # per-SLO-class attainment + tail latency (only when classed
        # traffic was offered, so class-less runs keep the old summary)
        for slo in self.slo_classes():
            if slo == "standard" and len(self.slo_classes()) == 1:
                break
            att = self.class_attainment(slo)
            out[f"attainment_{slo}"] = att if att is not None else 1.0
            if self.retain_traces:
                lat = self.latencies(slo)
                out[f"p99_latency_{slo}"] = (float(np.percentile(lat, 99))
                                             if lat.size else 0.0)
                out[f"misses_{slo}"] = int(sum(
                    t.slo == slo and not t.met_deadline
                    and np.isfinite(t.deadline_t)
                    for t in self.traces.values()))
            else:
                h = self._slo_hist.get(slo)
                out[f"p99_latency_{slo}"] = h.percentile(99) if h else 0.0
                fmiss = sum(agg.finite_misses
                            for (s, _), agg in self._agg.items()
                            if s == slo)
                live_miss = sum(t.slo == slo and np.isfinite(t.deadline_t)
                                for t in self.traces.values())
                out[f"misses_{slo}"] = int(fmiss + live_miss)
        # market mode: savings vs all-on-demand + by-market/by-strategy
        # breakdowns, billed through the same completion horizon as
        # fleet_dollar_cost (which keeps its static-rate semantics)
        if self.ledger is not None:
            out.update(self.ledger.report(now))
        return out

    def per_replica(self) -> List[Dict[str, float]]:
        return [{"rid": s.rid, "itype": s.itype, "tokens": s.tokens,
                 "tok_per_s": s.tokens / max(s.busy_s, 1e-9)}
                for s in self.replicas.values()]
