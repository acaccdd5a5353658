"""The single ordered event heap + named handlers.

``EventLoop`` is the only ``heapq`` in the repository's simulation
stack.  Subsystems register a handler per event *kind* and schedule
events onto the shared heap; ties at equal virtual time resolve by
schedule order (a monotone sequence number), so identical inputs give
bit-identical dispatch order — the substrate of every determinism
guarantee downstream.

Built to survive million-event runs:

* the heap stores ``(t, seq, event)`` tuples so ordering compares in C
  (no per-event dataclass ``__lt__``), and ``pending`` is an O(1) live
  counter instead of an O(n) heap scan;
* cancelled events buried deep in the heap (recurring rebalance /
  heartbeat / closed-loop cancellations) are *compacted* away once they
  outnumber the live entries, not just dropped when they surface at the
  top — ``(t, seq)`` is a total order, so a filter + ``heapify``
  provably preserves dispatch order (asserted bit-identical in tests);
* journaling is optional (``EventLoop(journal=False)``) for
  million-event runs; a running CRC-32 ``journal_digest`` over every
  dispatched ``(t, seq, kind)`` is maintained in BOTH modes, so two
  runs can assert bit-identical event timelines without storing one
  tuple per event.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import struct
import zlib
from typing import Callable, Dict, List, Optional, Tuple

# compact the heap when buried cancelled entries both exceed this floor
# and outnumber the live entries (amortized O(1) per cancellation)
_COMPACT_MIN = 64


@dataclasses.dataclass(order=True)
class Event:
    t: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    payload: dict = dataclasses.field(compare=False, default_factory=dict)
    cancelled: bool = dataclasses.field(compare=False, default=False)
    dispatched: bool = dataclasses.field(compare=False, default=False)


Handler = Callable[[Event, float], None]


class EventLoop:
    """Discrete-event scheduler over a shared :class:`VirtualClock`.

    * ``register(kind, fn)``    — name a handler (one per kind).
    * ``schedule(t, kind, **p)``— push an event; returns it (cancellable).
    * ``dispatch_next()``       — pop the earliest live event, advance the
                                  clock to its time, run its handler.
    * ``run(until=...)``        — dispatch until the heap drains or the
                                  next event lies beyond ``until``;
                                  raises ``RuntimeError`` if ``max_events``
                                  is exhausted with live work still due
                                  (a silently truncated sim would report
                                  partial metrics as if complete).

    The loop journals every dispatched ``(t, seq, kind)`` so tests can
    assert two runs produced bit-identical event timelines; pass
    ``journal=False`` to keep only the running ``journal_digest``
    (same bit-identity check, O(1) memory).
    """

    def __init__(self, clock=None, *, journal: bool = True):
        from repro_torch.runtime.clock import VirtualClock
        self.clock = clock if clock is not None else VirtualClock()
        # heap of (t, seq, Event): the tuple prefix is the total order
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = itertools.count()
        self._handlers: Dict[str, Handler] = {}
        self.keep_journal = journal
        self.journal: List[Tuple[float, int, str]] = []
        self.journal_digest = 0      # crc32 over dispatched (t, seq, kind)
        self.dispatched = 0          # events dispatched (journal or not)
        self.compactions = 0         # cancelled-entry compaction passes
        self._live = 0               # scheduled, not cancelled/dispatched
        self._buried = 0             # cancelled entries still in the heap

    # ------------------------------------------------------------ wiring
    def register(self, kind: str, handler: Handler):
        if kind in self._handlers:
            raise ValueError(f"handler for {kind!r} already registered")
        self._handlers[kind] = handler

    def now(self) -> float:
        return self.clock.now()

    # ------------------------------------------------------------ heap
    def schedule(self, t: float, kind: str, **payload) -> Event:
        ev = Event(float(t), next(self._seq), kind, payload)
        heapq.heappush(self._heap, (ev.t, ev.seq, ev))
        self._live += 1
        return ev

    def cancel(self, ev: Optional[Event]):
        if ev is None or ev.cancelled or ev.dispatched:
            return
        ev.cancelled = True
        self._live -= 1
        self._buried += 1
        self._maybe_compact()

    def _maybe_compact(self):
        """Rebuild the heap without cancelled entries once they dominate.

        ``(t, seq)`` is a total order (``seq`` is unique), so dropping
        dead entries and re-heapifying cannot change the pop order of
        the survivors — dispatch order, and therefore the journal, is
        bit-identical (asserted in tests/test_loop_scale.py).
        """
        if self._buried < _COMPACT_MIN or self._buried * 2 < len(self._heap):
            return
        self._heap = [e for e in self._heap if not e[2].cancelled]
        heapq.heapify(self._heap)
        self._buried = 0
        self.compactions += 1

    def _drop_cancelled(self):
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
            self._buried -= 1

    @property
    def pending(self) -> int:
        return self._live

    def peek_t(self) -> float:
        """Virtual time of the earliest live event (inf when empty)."""
        self._drop_cancelled()
        return self._heap[0][0] if self._heap else math.inf

    def peek(self) -> Optional[Event]:
        """The earliest live event without popping it (None when empty)."""
        self._drop_cancelled()
        return self._heap[0][2] if self._heap else None

    # ------------------------------------------------------------ dispatch
    def dispatch_next(self) -> Optional[Event]:
        self._drop_cancelled()
        if not self._heap:
            return None
        ev = heapq.heappop(self._heap)[2]
        ev.dispatched = True
        self._live -= 1
        self.clock.advance_to(ev.t)
        self.dispatched += 1
        self.journal_digest = zlib.crc32(
            struct.pack("<dq", ev.t, ev.seq) + ev.kind.encode(),
            self.journal_digest)
        if self.keep_journal:
            self.journal.append((ev.t, ev.seq, ev.kind))
        handler = self._handlers.get(ev.kind)
        if handler is None:
            raise ValueError(f"no handler registered for event {ev.kind!r}")
        handler(ev, ev.t)
        return ev

    def run(self, until: float = math.inf, max_events: int = 10_000_000) -> int:
        """Dispatch events with ``t <= until``; returns events dispatched.

        Raises ``RuntimeError`` when ``max_events`` is exhausted while a
        live event is still due at ``t <= until`` — a sim that silently
        stops mid-stream would report partial metrics as if complete.
        """
        n = 0
        while True:
            self._drop_cancelled()
            if not self._heap or self._heap[0][0] > until:
                break
            if n >= max_events:
                raise RuntimeError(
                    f"EventLoop.run exhausted max_events={max_events} with "
                    f"{self._live} live event(s) still due at "
                    f"t<={until} (next at t={self._heap[0][0]:g}); the "
                    f"simulation is truncated, not complete — raise "
                    f"max_events or check for a non-draining event chain")
            self.dispatch_next()
            n += 1
        return n
