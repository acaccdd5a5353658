"""A serving replica: a ``ServingEngine`` treated as a PE.

The cluster maps the paper's runtime objects onto serving (§III/§IV):
replicas are PEs with *measured* heterogeneous rates; in-flight requests
are migratable chares (``WorkUnit``s).  Each replica wraps an engine with

* an ``InstanceType`` (the EC2-flavor analogue: relative speed, spot
  flag, dollar cost per hour, accelerator flag),
* a feed into the shared ``RateMonitor`` — measured tokens/sec, never
  ground-truth speed, so stragglers and jitter are handled identically,
* one PUP-style verb set over in-flight work: ``pack_slots``/``unpack``
  (migration), ``preempt``/``resume`` (SLO-aware pausing), and
  ``drain_units`` (spot-drain/retirement).  Every verb that releases
  work stages the payload through the replica's ``MigrationEndpoint``
  — host-RAM (``InMemoryStore``) for plain instances, device-resident
  (``DeviceStore``) when ``InstanceType.accelerator`` is set — so the
  §IV checkpoint/restore stages are exercised and timed on the store
  class that host would really use.

Virtual-time pacing is *message-driven*: each replica schedules its own
next ``replica_step`` event on the shared ``EventLoop``.  One event runs
``decode_block`` fused engine steps (``ServingEngine.step_many``) in a
single dispatch; the next event is scheduled after the *accounted* cost
of that batch — ``decode_block / speed`` virtual seconds, plus any bulk
prefill chunk admitted in the batch at ``prefill_discount`` of a decode
step per chunk token (bulk prefill is cheaper per token than decode).
A 2x instance still runs twice as many decode steps per virtual second
and slow replicas never quantize fast ones to a global tick.  Decode
itself is real (jitted fused decode loop); only the pacing is simulated,
which keeps runs deterministic on any host.

Port of ``repro.cluster.replica``.  A replica lives on a ``device``
(the card unless the caller asks for ``"cpu"``): its engine is built
there and its endpoint restores there.  ``SimEngine`` ignores the
device and carries no cache.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.checkpointing import InMemoryStore
from repro_torch.core.rates import RateMonitor
from repro_torch.device import resolve_device
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.workunit import WorkUnit

from repro_torch.cluster.endpoint import (DeviceEndpoint, HostEndpoint,
                                          MigrationEndpoint)


@dataclasses.dataclass(frozen=True)
class InstanceType:
    name: str
    speed: float                 # engine steps per virtual second
    spot: bool = True
    model_id: str = "default"    # model pool this instance serves
    cost_per_hour: float = 1.0   # dollar cost per virtual hour alive
    accelerator: bool = False    # drains stage through DeviceStore


class ReplicaState(enum.Enum):
    LAUNCHING = "launching"      # requested; warming up until ready_at
    RUNNING = "running"
    AT_RISK = "at_risk"          # rebalance recommendation received
    DRAINING = "draining"        # interruption notice: no new admissions
    TERMINATED = "terminated"
    DEAD = "dead"                # hard-killed with zero notice: nothing
                                 # announced this — only a heartbeat-based
                                 # FailureDetector can discover it


class Replica:
    # class-level routability epoch: bumped by ANY replica's state or
    # quarantine transition (and by construction, i.e. fleet growth), so
    # routers can cache their admitting-replicas-by-pool index and only
    # rebuild it when membership could actually have changed.
    # Over-invalidation (e.g. RUNNING -> AT_RISK on a replica in another
    # pool) is harmless — the cache is just rebuilt.
    topology_epoch = 0

    def __init__(self, rid: int, cfg: ModelConfig, params,
                 itype: InstanceType, *, batch_size: int = 2,
                 max_seq: int = 64, temperature: float = 0.0,
                 monitor: Optional[RateMonitor] = None,
                 store: Optional[InMemoryStore] = None,
                 ready_at: float = 0.0, seed: int = 0,
                 decode_block: int = 4, prefill_mode: str = "chunked",
                 endpoint: Optional[MigrationEndpoint] = None,
                 engine_kwargs: Optional[dict] = None,
                 engine_cls=None, device="cuda"):
        self.rid = rid
        self.device = resolve_device(device)
        self.itype = itype
        self.decode_block = max(int(decode_block), 1)
        # engine_kwargs passes cache tuning straight through (e.g.
        # cache_mode="paged", block_size, kv_pool_blocks) without the
        # replica layer growing one parameter per engine knob;
        # engine_cls swaps the whole engine (e.g. the token-accounting
        # SimEngine for million-request matrix runs)
        engine_cls = engine_cls or ServingEngine
        self.engine = engine_cls(cfg, params, batch_size=batch_size,
                                 max_seq=max_seq,
                                 temperature=temperature,
                                 seed=seed + rid,
                                 prefill_mode=prefill_mode,
                                 decode_block=self.decode_block,
                                 device=self.device,
                                 **(engine_kwargs or {}))
        self.monitor = monitor
        self.store = store or InMemoryStore()
        # migration staging: accelerator hosts keep the round trip
        # device-resident (HBM-to-HBM); plain hosts stage through the
        # shared host-RAM store
        if endpoint is not None:
            self.endpoint = endpoint
        elif itype.accelerator:
            self.endpoint = DeviceEndpoint(device=self.device)
        else:
            self.endpoint = HostEndpoint(self.store, device=self.device)
        self.ready_at = ready_at
        self.state = ReplicaState.LAUNCHING if ready_at > 0 \
            else ReplicaState.RUNNING
        self.tokens_total = 0
        # market mode: the PurchaseRecord this replica was bought under
        # (which market, which strategy) — None outside market runs
        self.purchase = None
        self.completed: List[Request] = []
        self.step_event = None       # pending replica_step on the loop
        self.beat_event = None       # pending heartbeat on the loop
        self.last_step_cost = 1.0 / itype.speed
        # chaos state: slowdown windows degrade the effective speed,
        # stragglers can be quarantined (serving but not routable), and
        # a hard kill leaves a lost-work manifest for the detector
        self.slow_factor = 1.0
        self.slow_until = 0.0
        self.quarantined = False
        self.quarantined_t = 0.0
        self.killed_t: Optional[float] = None
        self.lost: Optional[Dict[str, list]] = None

    # ------------------------------------------------------------- status
    @property
    def state(self) -> ReplicaState:
        return self._state

    @state.setter
    def state(self, value: ReplicaState):
        self._state = value
        Replica.topology_epoch += 1

    @property
    def quarantined(self) -> bool:
        return self._quarantined

    @quarantined.setter
    def quarantined(self, value: bool):
        self._quarantined = bool(value)
        Replica.topology_epoch += 1

    @property
    def model_id(self) -> str:
        return self.itype.model_id

    @property
    def serving(self) -> bool:
        """Accepting and executing work (at-risk replicas still serve)."""
        return self.state in (ReplicaState.RUNNING, ReplicaState.AT_RISK)

    @property
    def admitting(self) -> bool:
        """Routable: serving, not scheduled for interruption, and not
        quarantined as a straggler (a quarantined replica finishes its
        in-flight work but takes nothing new until its rate recovers)."""
        return self.state == ReplicaState.RUNNING and not self.quarantined

    def has_work(self) -> bool:
        return self.engine.n_active > 0 or self.engine.n_queued > 0

    def backlog_tokens(self) -> float:
        return self.engine.backlog_tokens() if self.serving else 0.0

    # ------------------------------------------------------------- driving
    @property
    def step_interval(self) -> float:
        """Virtual seconds one engine step occupies on this instance
        (inflated by an active slowdown window — the RateMonitor then
        *measures* the degradation, which is what straggler detection
        keys off)."""
        return self.slow_factor / self.itype.speed

    def apply_slowdown(self, factor: float, until: float):
        self.slow_factor = max(float(factor), 1.0)
        self.slow_until = until

    def clear_slowdown(self, now: float):
        """End a slowdown window (no-op if a later window superseded)."""
        if now >= self.slow_until:
            self.slow_factor = 1.0

    def maybe_ready(self, now: float):
        if self.state == ReplicaState.LAUNCHING and now >= self.ready_at:
            self.state = ReplicaState.RUNNING

    def step_once(self, now: float) -> int:
        """Run ONE ``replica_step`` event: ``decode_block`` fused engine
        steps in a single dispatch; returns tokens emitted.  The virtual
        cost of the batch (decode steps at ``step_interval`` each + any
        admitted bulk-prefill chunk at the engine's prefill discount) is
        stored in ``last_step_cost``; the caller schedules the next event
        that far out while work remains, so pacing is per-replica."""
        self.maybe_ready(now)
        if not self.serving:
            return 0
        stats = self.engine.step_many(self.decode_block)
        emitted = stats["emitted"]
        self.tokens_total += emitted
        self.completed.extend(self.engine.pop_completed())
        cost = (stats["steps"] + stats["chunk_tokens"]
                * self.engine.prefill_discount) * self.step_interval
        self.last_step_cost = max(cost, self.step_interval)
        if self.monitor is not None and stats["processed"] > 0:
            # measured work-units/sec (bulk-prefilled chunk tokens count
            # as full work units over their discounted cost, so measured
            # rates reflect the prefill/decode cost asymmetry) over the
            # virtual time this batch occupied — an idle replica
            # schedules no step events, so idle time never dilutes the
            # measurement
            self.monitor.record(self.rid, stats["processed"],
                                self.last_step_cost)
        return emitted

    def submit(self, req: Request):
        assert self.serving, self.state
        self.engine.submit(req)

    # ---------------------------------------------------- WorkUnit verbs
    def pack_slots(self, slots: Optional[List[int]] = None
                   ) -> Tuple[List[WorkUnit], Tuple[float, float]]:
        """Mid-stream migration: pack selected in-flight slots and
        release them, while the replica keeps serving everything else —
        the Charm++ migratable-chare move applied for *load*, not just
        spot-drain.  Payloads stage through this replica's endpoint;
        returns (units, (checkpoint_s, restore_s))."""
        units = self.engine.pack(slots)
        times = self._stage(units, f"migrate_r{self.rid}")
        return units, times

    def unpack(self, units: List[WorkUnit]):
        """Admit packed units (migration landing / preemption resume)."""
        assert self.serving, self.state
        self.engine.unpack(units)

    def preempt(self, slots: List[int]
                ) -> Tuple[List[WorkUnit], Tuple[float, float]]:
        """Pause in-flight slots (slot freed, snapshot retained): the
        SLO-aware preemption primitive.  Units come back PAUSED and stay
        parked until a ``resume`` re-admits them somewhere."""
        units = self.engine.preempt(slots)
        times = self._stage(units, f"preempt_r{self.rid}")
        return units, times

    def resume(self, units: List[WorkUnit]):
        """Re-admit paused units; the stream continues bit-identically."""
        assert self.serving, self.state
        self.engine.resume(units)

    def resize(self, *, batch_size: Optional[int] = None,
               decode_block: Optional[int] = None,
               kv_pool_blocks: Optional[int] = None,
               evict_key=None
               ) -> Tuple[List[WorkUnit], Tuple[float, float]]:
        """In-place vertical resize: change the engine's lane count /
        decode block / paged pool without draining — surviving slots
        keep decoding bit-identically.  Evicted units (a shrink past the
        live slot count) stage through the endpoint like any preemption
        and come back PAUSED; the caller parks and later resumes them.
        Bumps the topology epoch: routers cache per-pool capacity
        estimates that a resize invalidates."""
        assert self.serving, self.state
        evicted = self.engine.resize(batch_size=batch_size,
                                     decode_block=decode_block,
                                     kv_pool_blocks=kv_pool_blocks,
                                     evict_key=evict_key)
        if decode_block is not None:
            self.decode_block = max(int(decode_block), 1)
        Replica.topology_epoch += 1
        times = self._stage(evicted, f"resize_r{self.rid}") \
            if evicted else (0.0, 0.0)
        return evicted, times

    def drain_units(self) -> Tuple[List[WorkUnit], List[Request],
                                   Tuple[float, float]]:
        """Pack ALL in-flight work through the endpoint and empty the
        engine.  Returns (units, untouched queued requests,
        (checkpoint_s, restore_s))."""
        self.state = ReplicaState.DRAINING
        units, queued = self.engine.drain_units()
        times = self._stage(units, f"drain_r{self.rid}")
        return units, queued, times

    def _stage(self, units: List[WorkUnit], name: str
               ) -> Tuple[float, float]:
        for u in units:
            if u.origin is None:
                u.origin = self.rid
        return self.endpoint.roundtrip(units, name)

    # ------------------------------------------------ chaos & recovery
    def checkpoint_units(self) -> Tuple[List[WorkUnit], float]:
        """Periodic recovery checkpoint: NON-destructively snapshot
        every live slot and persist the payloads in this replica's
        endpoint store under a stable key.  The engine keeps decoding;
        returns (units, real checkpoint stage seconds)."""
        units = self.engine.checkpoint_units()
        for u in units:
            if u.origin is None:
                u.origin = self.rid
        ckpt_s = self.endpoint.put(units, f"ckpt_r{self.rid}") \
            if units else 0.0
        return units, ckpt_s

    def hard_kill(self, now: float) -> Dict[str, list]:
        """Zero-notice termination: the instance is simply gone.

        Captures the lost-work manifest (in-flight slot requests, the
        untouched queue, restore-queue requests) — the front-end's
        request log, which is what a FailureDetector recovers from.
        Tokens the engine already emitted are materialized first (the
        async poll lag is a simulation artifact, not delivery
        semantics), so the manifest records true kill-time progress and
        replay accounting is exact; slots that had in fact finished
        complete normally rather than count as lost.  The engine's
        device state is NOT consulted again after this: everything not
        checkpointed re-decodes from the prompt."""
        self.engine._poll()
        manifest = {
            "active": [r for _, r in self.engine.slot_requests()],
            "queued": list(self.engine.queued_requests()),
            "pending": [u.request for u in self.engine.pending_units()],
        }
        self.state = ReplicaState.DEAD
        self.killed_t = now
        self.lost = manifest
        return manifest

    def terminate(self):
        self.state = ReplicaState.TERMINATED
