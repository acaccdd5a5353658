"""EventLoop at scale: the three hot-path fixes behind the
million-request scenario matrix, each pinned by a regression test.

  * ``run(max_events=...)`` raises instead of silently truncating a
    simulation that still has live work due (a truncated sim must not
    report partial metrics as if complete);
  * cancelled-entry heap compaction keeps the heap proportional to
    LIVE events and is provably order-preserving: the dispatch journal
    is bit-identical to an uncompacted reference;
  * ``pending`` is an O(1) counter, exact under any mix of schedule /
    cancel / dispatch, and the CRC journal digest is identical whether
    or not the full journal list is retained.

A mirror of ``test_loop_scale.py`` on ``repro_torch.runtime``.
"""

import math

import pytest

from repro_torch.runtime import EventLoop, VirtualClock


def _loop(journal=True):
    loop = EventLoop(VirtualClock(), journal=journal)
    loop.register("noop", lambda ev, t: None)
    return loop


# ------------------------------------------------------- max_events guard
def test_run_raises_when_cap_truncates_live_work():
    loop = _loop()

    def rearm(ev, t):
        loop.schedule(t + 1.0, "chain")

    loop.register("chain", rearm)
    loop.schedule(0.0, "chain")
    with pytest.raises(RuntimeError, match=r"max_events=25"):
        loop.run(until=math.inf, max_events=25)


def test_run_cap_error_names_the_next_due_event():
    loop = _loop()
    for i in range(10):
        loop.schedule(float(i), "noop")
    with pytest.raises(RuntimeError, match=r"next at t=5"):
        loop.run(max_events=5)


def test_run_exact_cap_with_drained_loop_is_fine():
    loop = _loop()
    for i in range(10):
        loop.schedule(float(i), "noop")
    assert loop.run(max_events=10) == 10      # drained AT the cap: ok
    assert loop.pending == 0


def test_run_cap_ignores_events_beyond_until():
    loop = _loop()
    for i in range(10):
        loop.schedule(float(i), "noop")
    # only 3 events are due at t<=2.5; the rest are beyond the horizon,
    # so a cap of 3 truncates nothing
    assert loop.run(until=2.5, max_events=3) == 3


# ---------------------------------------------------------- compaction
def test_compaction_triggers_and_shrinks_the_heap():
    loop = _loop()
    evs = [loop.schedule(float(i), "noop") for i in range(1000)]
    for ev in evs[::2]:
        loop.cancel(ev)
    assert loop.compactions >= 1
    assert len(loop._heap) == loop.pending == 500


def test_compaction_journal_bit_identical_to_small_reference():
    """Drive the same schedule/cancel pattern at a size that compacts
    and assert the surviving dispatch order equals the (t, seq)-sorted
    survivors — the order an uncompacted heap would produce."""
    loop = _loop()
    evs = [loop.schedule(float(i % 97) * 0.5, "noop", i=i)
           for i in range(2000)]
    cancelled = {id(ev) for ev in evs if ev.seq % 3 != 0}
    for ev in evs:
        if id(ev) in cancelled:
            loop.cancel(ev)
    assert loop.compactions >= 1
    expected = sorted((ev.t, ev.seq, ev.kind) for ev in evs
                      if id(ev) not in cancelled)
    assert loop.run() == len(expected)
    assert loop.journal == expected


def test_compaction_digest_matches_cancel_order_permutation():
    """The same cancelled SET in a different cancel ORDER (different
    compaction points) must still dispatch bit-identically."""
    def drive(order):
        loop = _loop()
        evs = [loop.schedule(float(i) * 0.25, "noop") for i in range(1200)]
        doomed = [ev for ev in evs if ev.seq % 2 == 0]
        for ev in (doomed if order == "fwd" else doomed[::-1]):
            loop.cancel(ev)
        loop.run()
        return loop.journal_digest, loop.journal

    d_fwd, j_fwd = drive("fwd")
    d_rev, j_rev = drive("rev")
    assert d_fwd == d_rev
    assert j_fwd == j_rev


def test_cancelled_events_never_dispatch_after_compaction():
    loop = _loop()
    seen = []
    loop.register("mark", lambda ev, t: seen.append(ev.payload["i"]))
    evs = [loop.schedule(float(i), "mark", i=i) for i in range(500)]
    for ev in evs:
        if ev.payload["i"] % 2 == 1:
            loop.cancel(ev)
    loop.run()
    assert seen == list(range(0, 500, 2))


# ------------------------------------------------------- O(1) pending
def test_pending_tracks_schedule_cancel_dispatch_exactly():
    loop = _loop()
    evs = [loop.schedule(float(i), "noop") for i in range(300)]
    assert loop.pending == 300
    for ev in evs[:100]:
        loop.cancel(ev)
    assert loop.pending == 200
    loop.cancel(evs[0])                 # double-cancel: no double count
    assert loop.pending == 200
    loop.run(until=150.0)
    assert loop.pending == 300 - 100 - sum(1 for ev in evs[100:]
                                           if ev.t <= 150.0)
    loop.run()
    assert loop.pending == 0
    loop.cancel(evs[-1])                # cancel-after-dispatch: no-op
    assert loop.pending == 0


# ------------------------------------------------- digest vs journal mode
def test_digest_identical_with_journal_off():
    def drive(journal):
        loop = _loop(journal=journal)
        for i in range(200):
            loop.schedule(float(i % 13), "noop")
        loop.run()
        return loop

    on, off = drive(True), drive(False)
    assert on.journal_digest == off.journal_digest != 0
    assert len(on.journal) == 200
    assert off.journal == []            # bounded memory: digest only
