"""The port's copies of the discrete-event core and the rate monitor
against the JAX package's (both are Python and numpy: equal means equal).

* ``EventLoop``: the same schedule (ties, recurring events, cancellations
  past the compaction floor) gives the same journal, ``journal_digest``,
  dispatch and compaction counts.
* ``FaultTrace``: ``sampled`` and ``chaos_sampled`` give the same events
  for a seed; a trace file written by either package reads back in the
  other with the same events, and the two files are the same text;
  ``SpotEventFeed`` polls the same notices.
* ``RateMonitor``: the same rates, stragglers and resized history.
"""

import dataclasses

import numpy as np
import pytest

import repro.runtime as jrt
from repro.core.rates import RateMonitor as JaxMonitor
import repro_torch.runtime as prt
from repro_torch.core.rates import RateMonitor

SEEDS = [0, 1, 2, 7, 42]


def _drive_loop(pkg, seed):
    """A seeded schedule: 300 events at coarse times (many ties), each of
    kind 'a' rescheduling itself twice, every other one cancelled."""
    rng = np.random.default_rng(seed)
    loop = pkg.EventLoop()
    seen = []

    def on_a(ev, t):
        seen.append((t, ev.payload["i"]))
        if ev.payload["hops"] < 2:
            loop.schedule(t + float(rng.integers(1, 4)), "a",
                          i=ev.payload["i"], hops=ev.payload["hops"] + 1)

    loop.register("a", on_a)
    loop.register("b", lambda ev, t: seen.append((t, -1)))
    evs = [loop.schedule(float(rng.integers(0, 50)), "a" if i % 4 else "b",
                         i=i, hops=0) for i in range(300)]
    for ev in evs[::2]:
        loop.cancel(ev)
    n = loop.run(until=60.0)
    return (n, seen, loop.journal, loop.journal_digest, loop.dispatched,
            loop.compactions, loop.pending, loop.now())


@pytest.mark.parametrize("seed", SEEDS)
def test_event_loop_journal_digest_equals_jax(seed):
    port, ref = _drive_loop(prt, seed), _drive_loop(jrt, seed)
    assert port == ref
    assert port[5] > 0            # compaction ran


def _events(trace):
    return [dataclasses.astuple(n) for n in trace.events()]


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_traces_sample_equal(seed):
    kw = dict(rate=0.05, horizon=600.0, targets=5, seed=seed)
    assert _events(prt.FaultTrace.sampled(**kw)) == \
        _events(jrt.FaultTrace.sampled(**kw))
    port = prt.FaultTrace.chaos_sampled(**kw, factor=2.5, window=30.0)
    ref = jrt.FaultTrace.chaos_sampled(**kw, factor=2.5, window=30.0)
    assert _events(port) == _events(ref)
    assert [dataclasses.astuple(n) for n in port.chaos] == \
        [dataclasses.astuple(n) for n in ref.chaos]


def test_fault_trace_files_cross_read(tmp_path):
    traces = {}
    for name, pkg in (("port", prt), ("jax", jrt)):
        tr = pkg.FaultTrace.chaos_sampled(rate=0.05, horizon=900.0,
                                          targets=4, seed=3)
        tr.inject(1.0 / 3.0, 2)
        tr.inject(92.94171263538088, 0)
        traces[name] = tr
        tr.to_file(str(tmp_path / f"{name}.txt"))
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    for reader, writer in ((prt, "jax"), (jrt, "port")):
        back = reader.FaultTrace.from_file(str(tmp_path / f"{writer}.txt"))
        assert back.interruptions == traces[writer].interruptions
        assert _events(back) == _events(traces[writer])


def test_spot_feed_polls_equal():
    polled = {}
    for name, pkg in (("port", prt), ("jax", jrt)):
        feed = pkg.SpotEventFeed(rebalance_lead=5.0, notice_deadline=3.0)
        for t, target in ((10.0, 1), (10.0, 0), (4.0, 2)):
            feed.inject_interruption(t, target)
        out = []
        for now in (0.0, 9.0, 10.0, 15.0, 20.0, 100.0):
            out.append([dataclasses.astuple(n) for n in feed.poll(now)])
            out.append(feed.next_event_t)
        polled[name] = out
    assert polled["port"] == polled["jax"]
    assert prt.LIFECYCLE_KINDS == jrt.LIFECYCLE_KINDS
    assert prt.CHAOS_KINDS == jrt.CHAOS_KINDS


@pytest.mark.parametrize("seed", SEEDS)
def test_rate_monitor_matches_jax(seed):
    rng = np.random.default_rng(seed)
    port, ref = RateMonitor(4, alpha=0.4), JaxMonitor(4, alpha=0.4)
    for step in range(12):
        work = rng.integers(1, 8, 4).astype(float)
        secs = rng.uniform(0.1, 2.0, 4)
        secs[rng.integers(0, 4)] = 0.0 if step % 5 == 0 else secs[0]
        port.record_step(work, secs)
        ref.record_step(work, secs)
        np.testing.assert_array_equal(port.rates(), ref.rates())
    assert port.straggler_pes(0.8) == ref.straggler_pes(0.8)
    for n in (6, 3):
        port.resize(n)
        ref.resize(n)
        np.testing.assert_array_equal(port.rates(), ref.rates())


def test_rate_monitor_ewma_and_stragglers():
    mon = RateMonitor(4, alpha=0.5)
    for _ in range(10):
        mon.record_step([4, 4, 4, 4], [1.0, 1.0, 2.5, 1.0])
    r = mon.rates()
    assert r[2] < 0.6 * r[0]
    assert mon.straggler_pes(0.7) == [2]
