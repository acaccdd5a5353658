"""Periodic WorkUnit checkpoints: the recovery substrate for hard kills.

``CheckpointPolicy`` rides a recurring ``checkpoint`` event on the
cluster's EventLoop (off the hot decode path): each pass asks every
serving replica with live slots for a NON-destructive
``checkpoint_units()`` — the engine keeps decoding — and persists the
payloads in that replica's ``MigrationEndpoint`` store under a stable
per-replica key (Kub-style checkpoint-based recovery, arXiv:2410.10655,
mapped onto the WorkUnit verbs).

The catalog keeps only the LATEST checkpoint per replica.  When the
``FailureDetector`` confirms a replica dead, ``recover()`` pulls the
payloads back out of the store (real, timed restore) and hands the
units to the cluster, which rewinds each original request to its
checkpoint progress and re-admits the unit — the lost tail re-decodes
deterministically, so final streams are bit-identical to a fault-free
run.  Requests that were never checkpointed readmit from the prompt.

Port of ``repro.cluster.checkpoint`` (imports redirected).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.workunit import WorkUnit


@dataclasses.dataclass
class CheckpointRecord:
    t: float                     # virtual time the checkpoint was taken
    units: List[WorkUnit]
    name: str                    # store key in the replica's endpoint


class CheckpointPolicy:
    """Cadence + catalog for periodic recovery checkpoints.

    ``interval`` is the checkpoint period in virtual seconds: shorter
    means less replayed work after a hard kill, at more (measured)
    checkpoint staging overhead — the knob the ``cluster_chaos``
    benchmark turns.

    With ``adaptive=True`` the cadence self-tunes to what is at risk:
    the cluster reports every chaos event through ``note_fault`` and
    ``next_interval`` measures the in-flight token count, and the
    period scales by ``1 / (1 + pressure)`` where pressure sums recent
    faults (per ``fault_ref``) and in-flight tokens (per
    ``tokens_ref``) — more chaos or more live work means checkpoints
    land sooner, so less re-decode after a kill.  A fully quiet window
    (no recent faults, nothing in flight worth protecting) relaxes the
    period by ``quiet_relax`` instead.  Both directions are clamped to
    ``[min_interval, max_interval]``.
    """

    def __init__(self, interval: float = 15.0, *, adaptive: bool = False,
                 min_interval: Optional[float] = None,
                 max_interval: Optional[float] = None,
                 fault_window: float = 60.0, fault_ref: float = 2.0,
                 tokens_ref: float = 256.0, quiet_relax: float = 2.0):
        self.interval = float(interval)
        self.adaptive = bool(adaptive)
        self.min_interval = (self.interval / 4.0 if min_interval is None
                             else float(min_interval))
        self.max_interval = (self.interval * 4.0 if max_interval is None
                             else float(max_interval))
        if not self.min_interval <= self.interval <= self.max_interval:
            raise ValueError(
                f"need min <= interval <= max, got "
                f"[{self.min_interval}, {self.interval}, "
                f"{self.max_interval}]")
        self.fault_window = float(fault_window)
        self.fault_ref = max(float(fault_ref), 1e-9)
        self.tokens_ref = max(float(tokens_ref), 1e-9)
        self.quiet_relax = max(float(quiet_relax), 1.0)
        self._fault_times: List[float] = []
        self._catalog: Dict[int, CheckpointRecord] = {}

    # ------------------------------------------------- adaptive cadence
    def note_fault(self, t: float):
        """Record one chaos event (any kind) for the intensity signal."""
        self._fault_times.append(t)

    def _recent_faults(self, now: float) -> int:
        cutoff = now - self.fault_window
        self._fault_times = [t for t in self._fault_times if t >= cutoff]
        return len(self._fault_times)

    def next_interval(self, replicas, now: float) -> float:
        """Seconds until the next checkpoint pass.

        Non-adaptive policies return the fixed ``interval`` (the
        pre-existing behaviour); adaptive ones scale it by measured
        risk: recent chaos intensity and the token count currently in
        flight across serving replicas (what a kill would force to
        re-decode).
        """
        if not self.adaptive:
            return self.interval
        in_flight = sum(rep.engine.fed_tokens(slot)
                        for rep in replicas if rep.serving
                        for slot, _req in rep.engine.slot_requests())
        pressure = (self._recent_faults(now) / self.fault_ref
                    + in_flight / self.tokens_ref)
        if pressure <= 0.0:
            nxt = self.interval * self.quiet_relax
        else:
            nxt = self.interval / (1.0 + pressure)
        return min(max(nxt, self.min_interval), self.max_interval)

    def take(self, rep, now: float) -> Tuple[int, float]:
        """Checkpoint ``rep``'s live slots into its endpoint store;
        returns (units checkpointed, real checkpoint seconds).  May
        raise ``EndpointUnavailable`` past the retry budget — the
        caller skips the pass and tries again next interval."""
        units, ckpt_s = rep.checkpoint_units()
        if units:
            self._catalog[rep.rid] = CheckpointRecord(
                now, units, f"ckpt_r{rep.rid}")
        return len(units), ckpt_s

    def recover(self, rep) -> Tuple[List[WorkUnit], float]:
        """Pull ``rep``'s last checkpoint back out of its endpoint
        store; returns (units, real restore seconds).  The caller
        filters against the lost-work manifest (a unit whose request
        completed or migrated after the checkpoint must not revive)."""
        rec = self._catalog.pop(rep.rid, None)
        if rec is None:
            return [], 0.0
        restore_s = rep.endpoint.fetch(rec.units, rec.name)
        rep.endpoint.discard(rec.name)
        return rec.units, restore_s

    def drop(self, rid: int):
        """Forget a replica's checkpoint (graceful retirement)."""
        self._catalog.pop(rid, None)

    def latest_t(self, rid: int) -> float:
        rec = self._catalog.get(rid)
        return rec.t if rec is not None else float("-inf")
