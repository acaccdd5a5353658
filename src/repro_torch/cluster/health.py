"""Fleet health: heartbeat failure detection + straggler mitigation.

Two policies the chaos model is pointed at:

* :class:`FailureDetector` — a hard-killed replica announces NOTHING;
  the only signal is silence.  Replicas emit periodic ``heartbeat``
  events while alive; a recurring ``health_check`` scans beat ages
  through the suspect -> confirm -> recover ladder.  Tuning matters:
  ``network_contention`` inflates heartbeat delivery, so a too-tight
  ``suspect_after`` yields false suspicions (cleared when the late beat
  lands), while a too-loose ``confirm_after`` stretches recovery
  latency (measured in ``ClusterMetrics``).

* :class:`StragglerPolicy` — the paper's rate-aware load balancing
  pointed at processor variability instead of heterogeneity: replicas
  whose *measured* rate falls below a fleet-median fraction are
  quarantined (they finish in-flight work but take nothing new) and
  their urgent slots (finite deadlines) proactively migrate away.
  Release is by measured recovery, or by an idle probe so an empty
  quarantined replica gets another chance rather than rotting on a
  stale rate sample.

Port of ``repro.cluster.health`` (imports redirected).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


class FailureDetector:
    """Suspect -> confirm dead replicas from heartbeat silence, and
    cross-check liveness against request progress.

    The detector never reads replica state — only what the cluster's
    ``heartbeat`` handler records: beat timestamps, plus (optionally)
    the replica's cumulative processed-token counter and whether it was
    busy at beat time — so detection latency is an honest function of
    the heartbeat/check cadence and timeouts.

    Heartbeats alone miss a *wedged* replica: one that is alive enough
    to beat but no longer decodes (a hung device dispatch, a livelocked
    loop).  When ``progress_stale_after`` is set, a replica whose
    progress counter has not advanced for that long *while it was busy*
    is suspected too — and cleared the moment a beat shows the counter
    moving (or the replica going idle, which is healthy, not wedged).
    Wedge staleness only suspects; confirmation stays heartbeat-based
    (a wedged-but-beating replica is a candidate for operator action or
    straggler quarantine, not for declaring dead and re-running its
    work while it might still complete).
    """

    def __init__(self, *, heartbeat_interval: float = 3.0,
                 check_interval: float = 3.0,
                 suspect_after: float = 7.0,
                 confirm_after: float = 14.0,
                 progress_stale_after: Optional[float] = None):
        if not (suspect_after < confirm_after):
            raise ValueError("suspect_after must precede confirm_after")
        self.heartbeat_interval = float(heartbeat_interval)
        self.check_interval = float(check_interval)
        self.suspect_after = float(suspect_after)
        self.confirm_after = float(confirm_after)
        self.progress_stale_after = (
            None if progress_stale_after is None
            else float(progress_stale_after))
        self._last_beat: Dict[int, float] = {}
        # rid -> (progress counter value, time it last ADVANCED): the
        # timestamp freezes while the counter does, which is exactly the
        # wedge age the scan measures
        self._progress: Dict[int, Tuple[int, float]] = {}
        self._suspected: Set[int] = set()

    def beat(self, rid: int, now: float,
             progress: Optional[int] = None, busy: bool = False):
        """Record a heartbeat.  ``progress`` is the replica's cumulative
        processed-token counter at beat time and ``busy`` whether it
        held active slots; beats without them (birth beats, minimal
        transports) leave the progress record untouched."""
        self._last_beat[rid] = now
        if progress is None:
            return
        if not busy:
            # idle is healthy: drop the record so a later busy phase
            # starts its staleness clock fresh
            self._progress.pop(rid, None)
            return
        prev = self._progress.get(rid)
        if prev is None or progress != prev[0]:
            self._progress[rid] = (progress, now)

    def forget(self, rid: int):
        """Stop monitoring (graceful terminate / confirmed dead)."""
        self._last_beat.pop(rid, None)
        self._progress.pop(rid, None)
        self._suspected.discard(rid)

    def _wedge_age(self, rid: int, now: float) -> float:
        """Seconds the replica has been busy without progress (0 when
        not tracked or the cross-check is disabled)."""
        if self.progress_stale_after is None:
            return 0.0
        rec = self._progress.get(rid)
        return 0.0 if rec is None else now - rec[1]

    def scan(self, replicas, now: float
             ) -> Tuple[List[int], List[int], List[object]]:
        """One health-check pass over monitored replicas.

        Returns (newly suspected rids, cleared rids, confirmed-dead
        replicas).  A replica with no beat recorded yet is not
        monitored (its heartbeat chain hasn't started)."""
        suspects: List[int] = []
        cleared: List[int] = []
        confirmed: List[object] = []
        for rep in replicas:
            last = self._last_beat.get(rep.rid)
            if last is None:
                continue
            age = now - last
            wedged = (self.progress_stale_after is not None
                      and self._wedge_age(rep.rid, now)
                      >= self.progress_stale_after)
            if age >= self.confirm_after:
                confirmed.append(rep)
                self.forget(rep.rid)
            elif age >= self.suspect_after or wedged:
                if rep.rid not in self._suspected:
                    self._suspected.add(rep.rid)
                    suspects.append(rep.rid)
            elif rep.rid in self._suspected:
                self._suspected.discard(rep.rid)
                cleared.append(rep.rid)
        return suspects, cleared, confirmed


@dataclasses.dataclass
class QuarantineOrder:
    rid: int
    slots: Tuple[int, ...] = ()   # urgent slots to migrate away


@dataclasses.dataclass
class ReleaseOrder:
    rid: int


@dataclasses.dataclass
class StragglerPolicy:
    """Quarantine replicas whose measured rate drops below a
    fleet-median fraction; migrate their urgent work proactively.

    ``threshold`` — quarantine below this fraction of the pool-median
    measured rate; ``min_fleet`` — pools smaller than this have no
    meaningful median; ``probe_after`` — release an *idle* quarantined
    replica after this long, so a drained straggler (whose rate sample
    can no longer refresh) gets probed with new work instead of being
    benched forever.
    """

    threshold: float = 0.5
    min_fleet: int = 2
    probe_after: float = 30.0

    def orders(self, view, now: float) -> List[object]:
        rates = view.rates()
        out: List[object] = []
        pools = {r.model_id for r in view.replicas if r.serving}
        for pool in sorted(pools):
            members = [r for r in view.replicas
                       if r.serving and r.model_id == pool]
            if len(members) < self.min_fleet:
                continue
            med = float(np.median([rates.get(r.rid, 0.0)
                                   for r in members]))
            if med <= 0.0:
                continue
            floor = self.threshold * med
            for rep in members:
                rate = rates.get(rep.rid, 0.0)
                if rep.quarantined:
                    idle = rep.engine.n_active == 0
                    if rate >= floor or (
                            idle and now - rep.quarantined_t
                            >= self.probe_after):
                        out.append(ReleaseOrder(rep.rid))
                elif rate < floor:
                    urgent = tuple(
                        slot for slot, req in rep.engine.slot_requests()
                        if np.isfinite(req.deadline_t()))
                    out.append(QuarantineOrder(rep.rid, urgent))
        return out
