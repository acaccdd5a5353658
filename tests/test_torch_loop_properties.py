"""Property-based EventLoop tests (hypothesis, via _hypothesis_compat).

The three determinism substrates every downstream guarantee leans on,
now also covering the recurring ``rebalance``-style self-rescheduling
event the SLO layer added:

* same-timestamp events dispatch in schedule order (seq tie-break);
* two identically-driven loops produce bit-identical journals;
* cancelled pending events never dispatch (and cancelling a recurring
  event's current occurrence stops the chain).

Each ``@given`` test skips individually when hypothesis is missing (see
requirements-dev.txt); the plain companions below always run.

A mirror of ``test_loop_properties.py`` on ``repro_torch.runtime``.
"""

import math

import pytest

from repro_torch.runtime import EventLoop, VirtualClock

from tests._hypothesis_compat import given, settings, st


# ------------------------------------------------------------ strategies
# (evaluated at import; harmless stubs when hypothesis is absent)
_times = st.lists(st.floats(min_value=0.0, max_value=100.0,
                            allow_nan=False, allow_infinity=False),
                  min_size=1, max_size=40)


def _drive(times, cancel_idx=(), rebalance_every=None,
           rebalance_stop=math.inf):
    """Build a loop, schedule one 'a' event per time (in list order),
    optionally a self-rescheduling 'rebalance' chain, cancel the given
    schedule indices, run to completion.  Returns (loop, dispatched)."""
    loop = EventLoop(VirtualClock())
    dispatched = []
    loop.register("a", lambda ev, t: dispatched.append(
        ("a", t, ev.payload["i"])))

    state = {"ev": None}

    def rebalance(ev, t):
        dispatched.append(("rebalance", t, -1))
        state["ev"] = None
        if rebalance_every is not None and t + rebalance_every \
                <= rebalance_stop:
            state["ev"] = loop.schedule(t + rebalance_every, "rebalance")

    loop.register("rebalance", rebalance)
    events = [loop.schedule(t, "a", i=i) for i, t in enumerate(times)]
    if rebalance_every is not None:
        state["ev"] = loop.schedule(rebalance_every, "rebalance")
    for i in cancel_idx:
        loop.cancel(events[i % len(events)])
    loop.run()
    return loop, dispatched


# ------------------------------------------------------------- properties
@settings(max_examples=60, deadline=None)
@given(_times)
def test_same_timestamp_ties_break_by_schedule_order(times):
    _, dispatched = _drive(times)
    assert len(dispatched) == len(times)
    # stable sort by time == dispatch order (seq is schedule order)
    expected = sorted(range(len(times)), key=lambda i: (times[i], i))
    assert [i for _, _, i in dispatched] == expected


@settings(max_examples=40, deadline=None)
@given(_times, st.integers(min_value=1, max_value=7))
def test_journal_bit_identical_across_runs(times, every):
    """Identical inputs (including a recurring rebalance chain) give
    bit-identical journals AND dispatch orders."""
    stop = max(times) if times else 0.0
    a = _drive(times, rebalance_every=float(every), rebalance_stop=stop)
    b = _drive(times, rebalance_every=float(every), rebalance_stop=stop)
    assert a[0].journal == b[0].journal
    assert a[1] == b[1]
    assert a[0].journal                 # journalled something


@settings(max_examples=60, deadline=None)
@given(_times, st.sets(st.integers(min_value=0, max_value=39),
                       max_size=10))
def test_cancelled_events_never_dispatch(times, cancel):
    _, dispatched = _drive(times, cancel_idx=sorted(cancel))
    cancelled = {i % len(times) for i in cancel}
    seen = {i for _, _, i in dispatched}
    assert seen == set(range(len(times))) - cancelled


# --------------------------------------------- deterministic companions
# (always run, hypothesis or not — the same three properties at fixed
# inputs, plus recurring-event cancellation mid-chain)
def test_tie_break_fixed():
    _, dispatched = _drive([5.0, 1.0, 5.0, 5.0, 0.5])
    assert [i for _, _, i in dispatched] == [4, 1, 0, 2, 3]


def test_journal_identity_with_recurring_rebalance_fixed():
    times = [0.7, 3.0, 3.0, 9.5, 2.2]
    a = _drive(times, rebalance_every=2.0, rebalance_stop=9.5)
    b = _drive(times, rebalance_every=2.0, rebalance_stop=9.5)
    assert a[0].journal == b[0].journal and a[1] == b[1]
    rebalances = [t for kind, t, _ in a[1] if kind == "rebalance"]
    assert rebalances == [2.0, 4.0, 6.0, 8.0]   # the chain self-armed


def test_cancelling_recurring_event_stops_the_chain():
    loop = EventLoop(VirtualClock())
    fired = []
    state = {"ev": None}

    def rebalance(ev, t):
        fired.append(t)
        state["ev"] = loop.schedule(t + 1.0, "rebalance")
        if len(fired) == 3:
            loop.cancel(state["ev"])    # a handler cancels its successor
            state["ev"] = None

    loop.register("rebalance", rebalance)
    state["ev"] = loop.schedule(1.0, "rebalance")
    loop.run(until=100.0)
    assert fired == [1.0, 2.0, 3.0]
    assert loop.pending == 0


def test_cancel_is_idempotent_and_none_safe():
    loop = EventLoop(VirtualClock())
    loop.register("a", lambda ev, t: None)
    ev = loop.schedule(1.0, "a")
    loop.cancel(ev)
    loop.cancel(ev)                     # double-cancel: no-op
    loop.cancel(None)                   # None: no-op
    assert loop.run() == 0
    assert loop.peek() is None and loop.peek_t() == math.inf
