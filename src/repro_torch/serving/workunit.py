"""WorkUnit: the migratable unit of in-flight serving work.

Port of ``repro.serving.workunit``; the unit's payload is the port's
``SlotSnapshot``, whose cache columns are CPU torch tensors.

The paper's central abstraction is the migratable object (a Charm++
chare) with one uniform pack/unpack (PUP) interface: load balancing,
spot-drain and elastic rescaling are all the *same* mechanism applied
under different policies.  ``WorkUnit`` is that abstraction for serving:
an in-flight request checkpointed into a self-contained, migratable
value.

One verb set everywhere (engine, replica, cluster):

* ``pack(slots) -> [WorkUnit]``   — checkpoint + release occupied slots;
* ``unpack(units)``               — admit units into any engine built
                                    from the same ``(cfg, max_seq)``;
* ``preempt(slots) -> [WorkUnit]``— pause slots (slot freed, snapshot
                                    retained); units come back PAUSED;
* ``resume(units)``               — re-admit paused units; the decoded
                                    stream continues bit-identically.

``pack``/``preempt`` are mechanically the same checkpoint; the verbs
differ in intent and bookkeeping — a packed unit is in transit to
another host (migration/drain), a paused unit is parked to free capacity
(SLO-aware preemption) and stays accounted to its origin until resumed.
Because the checkpoint is exact (cache columns + progress counters, see
``SlotSnapshot``), any interleaving of the four verbs round-trips to an
identical greedy token stream — property-tested in
``tests/test_workunit.py``.  The snapshot's cache columns are always
*canonical contiguous* (full ``max_seq`` sequence axes), independent of
the source engine's cache mode: paged engines gather their blocks into
that layout on ``pack`` and re-block on ``unpack``, so a unit moves
freely between dense and paged engines — including paged engines with
different block sizes.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, List, Optional

from repro_torch.serving.engine import (DEFAULT_PREFILL_DISCOUNT,
                                        Request, SlotSnapshot)

# Lifecycle states a unit can be observed in between engines.
PACKED = "packed"        # checkpointed for migration (drain / rebalance)
PAUSED = "paused"        # preempted: parked to free capacity, not in transit

# Payload residency: which store class the unit's cache columns last
# round-tripped through (the ``MigrationEndpoint`` stamps this).
RESIDENCY_NONE = "none"      # packed straight from the engine, not staged
RESIDENCY_HOST = "host"      # host-RAM store (Linux-shm analogue, §II-B)
RESIDENCY_DEVICE = "device"  # device-resident store (daemon analogue, §IV-A)

_UIDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class Hop:
    """One provenance entry: what happened to a unit, where, and when."""
    rid: int        # replica involved
    t: float        # virtual time of the event
    reason: str     # interruption | scale_down | rebalance | preempt |
                    # land | resume


@dataclasses.dataclass
class WorkUnit:
    """A migratable chare: checkpointed request + identity + residency.

    ``snapshot`` is the exact resume payload (``SlotSnapshot``: request,
    progress counters, this slot's cache columns as host arrays).  The
    rest is control-plane metadata: a stable identity across hops, the
    unit's lifecycle state, where its payload currently resides, and
    provenance — ``uid`` survives re-packing on a destination engine
    (the engine remembers which unit each restored slot came from), and
    ``hops`` accumulates one :class:`Hop` per control-plane move, so a
    spot-drain -> fallback -> rebalance chain is traceable end-to-end.
    """

    snapshot: SlotSnapshot
    uid: int = dataclasses.field(default_factory=lambda: next(_UIDS))
    state: str = PACKED             # PACKED | PAUSED
    residency: str = RESIDENCY_NONE
    origin: Optional[int] = None    # replica rid that first packed the unit
    packed_t: Optional[float] = None  # virtual time of the checkpoint
    hops: List[Hop] = dataclasses.field(default_factory=list)

    # --------------------------------------------------------- provenance
    def record_hop(self, rid: int, t: float, reason: str):
        """Append one provenance entry (cluster layer: it knows time)."""
        self.hops.append(Hop(rid, float(t), reason))

    @property
    def n_hops(self) -> int:
        return len(self.hops)

    # ------------------------------------------------------------ payload
    @property
    def request(self) -> Request:
        return self.snapshot.request

    @property
    def rid(self) -> int:
        return self.snapshot.request.rid

    @property
    def slo(self) -> Optional[Any]:
        """The request's ``SLOClass`` (None = cluster default)."""
        return self.snapshot.request.slo

    @property
    def slo_name(self) -> str:
        slo = self.snapshot.request.slo
        return slo.name if slo is not None else "standard"

    @property
    def preemptible(self) -> bool:
        """Lazily-admitted (batch) classes may be paused to free capacity."""
        slo = self.snapshot.request.slo
        return bool(slo is not None and slo.admit_lazily)

    # ----------------------------------------------------------- progress
    @property
    def progress(self) -> int:
        """Measured progress: prompt+generated tokens already in cache."""
        return self.snapshot.fed

    @property
    def remaining_tokens(self) -> int:
        return self.snapshot.remaining_tokens

    def remaining_cost(self,
                       discount: float = DEFAULT_PREFILL_DISCOUNT) -> float:
        """Remaining discounted load (the router/rebalancer signal)."""
        return self.snapshot.remaining_cost(discount)
