"""QoS-classed capacity: SLO classes mapped onto Kube-DRM-style tiers.

Kubernetes (and the Kube-DRM in-place-resize work built on it) grades
pods by their request/limit shape into **Guaranteed** (requests ==
limits: capacity reserved, evicted last), **Burstable** (requests <
limits: may use spare capacity, evicted before Guaranteed) and
**BestEffort** (no requests: runs purely on idle capacity, evicted
first).  This module mirrors that contract onto the serving fleet's
``SLOClass``es:

* ``interactive`` (priority 0) -> **Guaranteed**: slots reserved, never
  held at the door, last to be evicted by a shrink.
* ``standard`` (priority 1)    -> **Burstable**: normal admission,
  evicted before Guaranteed under a shrink.
* ``batch`` / any lazily-admitted class -> **BestEffort**: bursts into
  idle capacity only (held at the door while the pool has none beyond
  the Guaranteed reservation), first evicted by a shrink.

``QoSPolicy`` is the enforcement object the cluster composes with its
``PreemptionPolicy``: its ``hold``/``admit_held`` gate runs *after* the
preemption policy's headroom gate (either may hold), and its
``evict_key`` orders ``ServingEngine.resize`` evictions so a shrink
takes BestEffort work first.  Deadline urgency within a tier is still
``SLOPreemption``'s job — QoS decides *who owns capacity*, preemption
decides *who yields it right now*.

Port of ``repro.vertical.qos``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class QoSClass:
    name: str
    eviction_rank: int        # higher = evicted earlier under a shrink
    reserved: bool = False    # capacity is reserved for this tier
    burst_only: bool = False  # admits only into idle (unreserved) capacity


GUARANTEED = QoSClass("guaranteed", 0, reserved=True)
BURSTABLE = QoSClass("burstable", 1)
BEST_EFFORT = QoSClass("best_effort", 2, burst_only=True)

QOS_CLASSES: Tuple[QoSClass, ...] = (GUARANTEED, BURSTABLE, BEST_EFFORT)


def qos_for(slo) -> QoSClass:
    """Map an ``SLOClass`` (or None) onto its QoS tier.

    Lazily-admitted classes are BestEffort regardless of priority (they
    already consented to waiting at the door); priority 0 is Guaranteed;
    everything else — including class-less requests — is Burstable.
    """
    if slo is None:
        return BURSTABLE
    if slo.admit_lazily or slo.priority >= 2:
        return BEST_EFFORT
    if slo.priority == 0:
        return GUARANTEED
    return BURSTABLE


class QoSPolicy:
    """Admission + eviction enforcement over the QoS tiers.

    ``reserve_frac`` of each replica's lanes is the Guaranteed
    reservation: BestEffort arrivals are held at the door unless some
    admitting replica in their pool has a genuinely idle lane beyond
    that reservation and beyond already-placed waiting work (the
    "bursts into idle capacity" contract).  Guaranteed and Burstable
    admission is untouched — their gates stay with the preemption
    policy's headroom logic.
    """

    def __init__(self, reserve_frac: float = 0.25):
        if not 0.0 <= reserve_frac < 1.0:
            raise ValueError(f"reserve_frac must be in [0, 1), "
                             f"got {reserve_frac}")
        self.reserve_frac = reserve_frac

    # ------------------------------------------------------------ tiers
    @staticmethod
    def qos_for(slo) -> QoSClass:
        return qos_for(slo)

    def reserved_slots(self, rep) -> int:
        """Lanes held back for Guaranteed work on one replica."""
        return int(rep.engine.batch * self.reserve_frac)

    # -------------------------------------------------------- admission
    def _pool_has_idle(self, model_id: str, view) -> bool:
        for rep in view.pool(model_id):
            spare = (rep.engine.free_slots - len(view.waiting(rep))
                     - self.reserved_slots(rep))
            if spare > 0:
                return True
        return False

    def hold(self, req, view) -> bool:
        """Door gate: BestEffort waits while its pool has no idle lane
        beyond the Guaranteed reservation."""
        if not qos_for(req.slo).burst_only:
            return False
        return not self._pool_has_idle(req.model_id, view)

    def admit_held(self, held: Sequence, view) -> Tuple[List, List]:
        """Split held arrivals into (admit now, keep holding)."""
        admit, still = [], []
        for req in held:
            (still if self.hold(req, view) else admit).append(req)
        return admit, still

    # --------------------------------------------------------- eviction
    @staticmethod
    def evict_key(u) -> Tuple:
        """Keep-preference for ``resize``: Guaranteed kept first,
        BestEffort evicted first; within a tier the stream with the
        most progress survives (least wasted sunk work), uid tiebreak."""
        return (qos_for(u.slo).eviction_rank, -u.snapshot.fed, u.uid)
