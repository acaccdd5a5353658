"""``FaultTrace`` on the port: the cases of ``test_faults.py``.

File round-trips of spot lifecycles and chaos faults, late injection
into a bound ``EventLoop``, equal-timestamp delivery order, and the
seeded chaos soup, on ``repro_torch.runtime``, each with the reference
test's own assertions.  Then the schedules themselves against the
reference's: the same injections give the same events, the same soup
seed the same faults, and a trace file written by either package reads
back in the other.  The market-driven schedule's case is
``test_torch_market.py``'s.
"""

import pytest

from repro.runtime import FaultTrace as JaxTrace
from repro_torch.runtime import EventLoop, FaultTrace


def test_trace_file_roundtrip(tmp_path):
    """``to_file`` -> ``from_file`` reproduces the schedule exactly,
    including floats with no short decimal form."""
    trace = FaultTrace(rebalance_lead=6.0, notice_deadline=4.0)
    trace.inject(1.0 / 3.0, 2)
    trace.inject(92.94171263538088, 0)
    trace.inject(100.0, 1)
    p = tmp_path / "faults.txt"
    trace.to_file(str(p))
    back = FaultTrace.from_file(str(p), rebalance_lead=6.0,
                                notice_deadline=4.0)
    assert back.interruptions == trace.interruptions
    assert [(n.t, n.kind, n.target) for n in back.events()] \
        == [(n.t, n.kind, n.target) for n in trace.events()]


def test_inject_after_bind_reaches_the_loop():
    """A lifecycle injected AFTER ``bind`` still schedules its events on
    the bound loop — the enabler for market-driven injection, where every
    mid-run fallback purchase samples a fresh interruption."""
    trace = FaultTrace(rebalance_lead=10.0, notice_deadline=5.0)
    trace.inject(50.0, 0)                 # before bind
    loop = EventLoop()
    seen = []
    loop.register("spot", lambda ev, t: seen.append(
        (t, ev.payload["notice"].kind, ev.payload["notice"].target)))
    trace.bind(loop)
    trace.inject(20.0, 1)                 # after bind, BEHIND the first
    loop.run()
    assert seen == [
        (20.0, "rebalance_recommendation", 1),
        (30.0, "interruption_notice", 1),
        (35.0, "terminate", 1),
        (50.0, "rebalance_recommendation", 0),
        (60.0, "interruption_notice", 0),
        (65.0, "terminate", 0)]


def test_equal_timestamp_events_poll_in_injection_order():
    """Ties in time break by injection sequence, and a subscription
    delivers each event exactly once even when a lifecycle lands behind
    an already-polled watermark."""
    trace = FaultTrace(rebalance_lead=0.0, notice_deadline=0.0)
    trace.inject(10.0, 3)
    trace.inject(10.0, 1)                 # same instant, later injection
    sub = trace.subscribe()
    assert [(n.target, n.kind) for n in sub.poll(10.0)] == [
        (3, "rebalance_recommendation"), (3, "interruption_notice"),
        (3, "terminate"),
        (1, "rebalance_recommendation"), (1, "interruption_notice"),
        (1, "terminate")]
    trace.inject(5.0, 2)                  # behind the watermark
    assert [n.target for n in sub.poll(10.0)] == [2, 2, 2]
    assert sub.poll(10.0) == []


def test_chaos_kinds_file_roundtrip(tmp_path):
    """Chaos faults ride the same trace file as spot lifecycles: mixed
    schedules round-trip exactly, parameters included."""
    trace = FaultTrace(rebalance_lead=6.0, notice_deadline=4.0)
    trace.inject(1.0 / 3.0, 2)                       # spot lifecycle
    trace.inject_hard_kill(7.25, 0)
    trace.inject_slowdown(2.0 / 7.0, 1, factor=3.5, duration=12.5)
    trace.inject_contention(9.0, factor=2.0, duration=8.0)
    trace.inject_endpoint_failure(11.0, 1, count=3)
    p = tmp_path / "chaos.txt"
    trace.to_file(str(p))
    back = FaultTrace.from_file(str(p), rebalance_lead=6.0,
                                notice_deadline=4.0)
    assert back.interruptions == trace.interruptions
    assert [(n.t, n.kind, n.target, n.factor, n.duration, n.count)
            for n in back.chaos] \
        == [(n.t, n.kind, n.target, n.factor, n.duration, n.count)
            for n in trace.chaos]
    assert [(n.t, n.kind, n.target) for n in back.events()] \
        == [(n.t, n.kind, n.target) for n in trace.events()]


def test_chaos_inject_after_bind_reaches_the_loop():
    """Chaos kinds injected after ``bind`` land on the bound loop in
    time order, interleaved with lifecycle events, parameters intact."""
    trace = FaultTrace(rebalance_lead=10.0, notice_deadline=5.0)
    trace.inject_slowdown(40.0, 2, factor=2.0, duration=6.0)  # before bind
    loop = EventLoop()
    seen = []
    loop.register("spot", lambda ev, t: seen.append(
        (t, ev.payload["notice"].kind, ev.payload["notice"].target)))
    trace.bind(loop)
    trace.inject_hard_kill(25.0, 0)       # after bind, BEHIND the first
    trace.inject(20.0, 1)                 # lifecycle interleaves
    notice = trace.inject_endpoint_failure(45.0, 1, count=2)
    assert notice.count == 2
    loop.run()
    assert seen == [
        (20.0, "rebalance_recommendation", 1),
        (25.0, "hard_kill", 0),
        (30.0, "interruption_notice", 1),
        (35.0, "terminate", 1),
        (40.0, "slowdown", 2),
        (45.0, "endpoint_failure", 1)]


def test_chaos_sampled_soup_is_seed_deterministic():
    """One seed, one soup: ``chaos_sampled`` replays identically (the
    recovery-on/off A/B depends on this), and every fault is a known
    chaos kind."""
    from repro_torch.runtime import CHAOS_KINDS
    kw = dict(rate=0.1, horizon=300.0, targets=4, seed=11)
    a = FaultTrace.chaos_sampled(**kw)
    b = FaultTrace.chaos_sampled(**kw)
    assert a.chaos, "soup sampled empty"
    assert [(n.t, n.kind, n.target) for n in a.chaos] \
        == [(n.t, n.kind, n.target) for n in b.chaos]
    assert all(n.kind in CHAOS_KINDS for n in a.chaos)
    c = FaultTrace.chaos_sampled(**{**kw, "seed": 12})
    assert [(n.t, n.kind) for n in a.chaos] \
        != [(n.t, n.kind) for n in c.chaos]


def _events(trace):
    return [(n.t, n.kind, n.target) for n in trace.events()]


def _chaos(trace):
    return [(n.t, n.kind, n.target, n.factor, n.duration, n.count)
            for n in trace.chaos]


def _inject(trace):
    trace.inject(1.0 / 3.0, 2)
    trace.inject_hard_kill(7.25, 0)
    trace.inject_slowdown(2.0 / 7.0, 1, factor=3.5, duration=12.5)
    trace.inject_contention(9.0, factor=2.0, duration=8.0)
    trace.inject_endpoint_failure(11.0, 1, count=3)
    trace.inject(92.94171263538088, 0)
    return trace


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_schedules_and_files_match_reference(writer, tmp_path):
    """The same injections give the reference's events and chaos faults;
    a file written by one package reads back in the other exactly."""
    kw = dict(rebalance_lead=6.0, notice_deadline=4.0)
    port, ref = _inject(FaultTrace(**kw)), _inject(JaxTrace(**kw))
    assert _events(port) == _events(ref)
    assert _chaos(port) == _chaos(ref)
    assert port.interruptions == ref.interruptions
    p = tmp_path / "faults.txt"
    (port if writer == "port" else ref).to_file(str(p))
    back = (JaxTrace if writer == "port" else FaultTrace).from_file(
        str(p), **kw)
    assert _events(back) == _events(ref)
    assert _chaos(back) == _chaos(ref)


def test_chaos_soup_matches_reference():
    """``chaos_sampled`` draws the reference's soup for the same seed."""
    kw = dict(rate=0.1, horizon=300.0, targets=4, seed=11)
    assert _chaos(FaultTrace.chaos_sampled(**kw)) == \
        _chaos(JaxTrace.chaos_sampled(**kw))
