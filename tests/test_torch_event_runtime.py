"""Shared discrete-event core on the port: ordering, fault traces,
determinism.

The cases of ``test_event_runtime.py`` that need no ``CloudManager``
(``core/cloud.py`` is ROADMAP item 12), on the port's runtime, cluster
(``device="cpu"``, reduced granite-8b) and tile runtime:
  * one EventLoop heap serves every subsystem, ties broken by schedule
    order, so identical inputs give bit-identical event timelines;
  * a FaultTrace drives a ServingCluster drain and the tile runtime at
    its lifecycle timestamps;
  * open-loop arrival processes are seeded and replayable.
"""

import numpy as np
import pytest

from repro_torch.cluster import InstanceType, RateAwareRouter, ServingCluster
from repro_torch.configs import get_config
from repro_torch.core.overdecomp import (HostTileRuntime, TileGrid,
                                         TileRuntimeDriver)
from repro_torch.models import model_zoo as zoo
from repro_torch.runtime import (EventLoop, FaultTrace, SpotEventFeed,
                                 VirtualClock)
from repro_torch.serving.workload import (BatchArrivals, PoissonArrivals,
                                          TraceArrivals, make_arrivals,
                                          synthetic_requests)


@pytest.fixture(scope="module")
def model():
    cfg = get_config("granite-8b").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    return cfg, params


FLEET = [InstanceType("fast.2x", 2.0), InstanceType("slow.1x", 0.7)]


# ----------------------------------------------------------------- loop
def test_event_loop_orders_by_time_then_seq():
    loop = EventLoop()
    seen = []
    loop.register("a", lambda ev, t: seen.append((t, ev.payload["i"])))
    loop.schedule(2.0, "a", i=0)
    loop.schedule(1.0, "a", i=1)
    loop.schedule(1.0, "a", i=2)    # same t: schedule order breaks the tie
    assert loop.run() == 3
    assert seen == [(1.0, 1), (1.0, 2), (2.0, 0)]
    assert [j[0] for j in loop.journal] == [1.0, 1.0, 2.0]


def test_event_loop_cancel_and_until():
    loop = EventLoop()
    seen = []
    loop.register("a", lambda ev, t: seen.append(t))
    ev = loop.schedule(1.0, "a")
    loop.schedule(2.0, "a")
    loop.schedule(5.0, "a")
    loop.cancel(ev)
    assert loop.run(until=3.0) == 1
    assert seen == [2.0] and loop.now() == 2.0 and loop.peek_t() == 5.0


def test_event_loop_rejects_duplicate_and_unknown_kinds():
    loop = EventLoop()
    loop.register("a", lambda ev, t: None)
    with pytest.raises(ValueError):
        loop.register("a", lambda ev, t: None)
    loop.schedule(1.0, "mystery")
    with pytest.raises(ValueError):
        loop.run()


def test_handlers_can_schedule_during_dispatch():
    loop = EventLoop(VirtualClock())
    seen = []

    def chain(ev, t):
        seen.append(t)
        if t < 3.0:
            loop.schedule(t + 1.0, "chain")

    loop.register("chain", chain)
    loop.schedule(1.0, "chain")
    loop.run()
    assert seen == [1.0, 2.0, 3.0]


# ----------------------------------------------------------------- trace
def test_fault_trace_materializes_lifecycle():
    trace = FaultTrace(rebalance_lead=10.0, notice_deadline=5.0)
    trace.inject(t=100.0, target=7)
    assert [(n.t, n.kind) for n in trace.events()] == [
        (100.0, "rebalance_recommendation"),
        (110.0, "interruption_notice"),
        (115.0, "terminate")]


def test_fault_trace_sampled_is_seeded():
    kw = dict(rate=0.01, horizon=2000.0, targets=4, seed=3)
    a, b = FaultTrace.sampled(**kw), FaultTrace.sampled(**kw)
    assert a.interruptions == b.interruptions and a.interruptions
    assert a.interruptions != FaultTrace.sampled(**{**kw,
                                                    "seed": 4}).interruptions


def test_fault_trace_from_file(tmp_path):
    p = tmp_path / "faults.txt"
    p.write_text("# t target\n5.0 1\n12.5 0\n")
    trace = FaultTrace.from_file(str(p), rebalance_lead=1.0,
                                 notice_deadline=1.0)
    assert trace.interruptions == [(5.0, 1), (12.5, 0)]
    assert trace.events()[0].t == 5.0


def test_feed_is_a_view_over_a_shared_trace():
    trace = FaultTrace(rebalance_lead=10.0, notice_deadline=5.0)
    feed_a, feed_b = (SpotEventFeed(trace=trace),
                      SpotEventFeed(trace=trace))
    feed_a.inject_interruption(t=100.0, target=7)    # lands on the trace
    assert [n.kind for n in feed_b.poll(110.0)] == [
        "rebalance_recommendation", "interruption_notice"]
    assert feed_b.next_event_t == 115.0
    # independent cursors: feed_a has consumed nothing yet
    assert feed_a.next_event_t == 100.0
    # a lifecycle injected BEHIND feed_b's poll watermark still delivers
    trace.inject(t=50.0, target=3)
    assert [(n.t, n.target) for n in feed_b.poll(60.0)] == [
        (50.0, 3), (60.0, 3)]


# ----------------------------------------------------------------- arrivals
def test_arrival_processes():
    reqs = synthetic_requests(8, 200, seed=0)
    assert [t for t, _ in BatchArrivals(reqs)] == [0.0] * 8
    pa, pb = (list(PoissonArrivals(reqs, 2.0, seed=1)),
              list(PoissonArrivals(reqs, 2.0, seed=1)))
    assert [t for t, _ in pa] == [t for t, _ in pb]
    assert all(t1 > t0 for (t0, _), (t1, _) in zip(pa, pa[1:]))
    ta = list(TraceArrivals(reqs, [3.0, 1.0, 2.0]))
    assert [t for t, _ in ta] == [1.0, 2.0, 3.0]     # sorted, truncates


def test_make_arrivals_specs(tmp_path):
    reqs = synthetic_requests(3, 200, seed=0)
    assert isinstance(make_arrivals("batch", reqs), BatchArrivals)
    assert isinstance(make_arrivals("poisson:1.5", reqs), PoissonArrivals)
    p = tmp_path / "arrivals.txt"
    p.write_text("0.5\n1.5\n2.5\n")
    tr = make_arrivals(f"trace:{p}", reqs)
    assert [t for t, _ in tr] == [0.5, 1.5, 2.5]
    with pytest.raises(ValueError):
        make_arrivals("uniform:3", reqs)


# ----------------------------------------------------------------- determinism
def _drive_cluster(model, trace):
    cfg, params = model
    cl = ServingCluster(cfg, params, FLEET, router=RateAwareRouter(),
                        dt=1.0, batch_size=2, max_seq=32, trace=trace,
                        device="cpu")
    reqs = synthetic_requests(8, 200, seed=0, prompt_len=(3, 8))
    cl.attach_arrivals(PoissonArrivals(reqs, 2.0, seed=5))
    return cl, cl.run(max_time=5000)


def test_cluster_event_timeline_bit_identical(model):
    runs = []
    for _ in range(2):
        trace = FaultTrace(rebalance_lead=4.0, notice_deadline=3.0)
        trace.inject(2.0, 0)
        runs.append(_drive_cluster(model, trace))
    (cl_a, out_a), (cl_b, out_b) = runs
    assert cl_a.loop.journal == cl_b.loop.journal   # every event, bit-equal
    assert cl_a.timeline == cl_b.timeline
    # interruption_overhead_s is REAL measured store time (wall-clock);
    # everything virtual must match bit-for-bit
    drop = "interruption_overhead_s"
    assert ({k: v for k, v in out_a.items() if k != drop}
            == {k: v for k, v in out_b.items() if k != drop})


def _lifecycle_ts(timeline, key):
    return [t for t, msg in timeline if msg.startswith(key)]


def test_same_timestamp_arrivals_coalesce_to_one_router_pass(model):
    cfg, params = model
    cl = ServingCluster(cfg, params, FLEET, router=RateAwareRouter(),
                        dt=1.0, batch_size=2, max_seq=32, device="cpu")
    calls = []
    inner = cl.router.dispatch
    cl.router.dispatch = lambda *a, **kw: (calls.append(cl.clock.now()),
                                           inner(*a, **kw))[1]
    reqs = synthetic_requests(8, 200, seed=0, prompt_len=(3, 8))
    cl.attach_arrivals(BatchArrivals(reqs))
    out = cl.run(max_time=5000)
    assert out["completed"] == 8
    assert calls.count(0.0) == 1, calls   # 8 arrivals at t=0 -> ONE pass


def test_tile_runtime_replays_same_trace():
    """The stencil app checkpoints at exactly the trace's notice time."""
    trace = FaultTrace(rebalance_lead=2.0, notice_deadline=2.0)
    trace.inject(3.0, 0)
    loop = EventLoop()
    rt = HostTileRuntime(TileGrid(32, 32, 4, 4), n_pes=4, odf=4,
                         device="cpu")
    drv = TileRuntimeDriver(rt, loop, iters=10, step_interval=1.0,
                            lb_interval=4.0, trace=trace)
    loop.run()
    assert rt.iteration == 10
    assert [t for t, _ in drv.checkpoints] == [5.0]   # 3.0 + lead 2.0
    snap_t, snap = drv.checkpoints[0]
    assert snap["iteration"] > 0 and "tiles" in snap
    assert _lifecycle_ts(drv.timeline, "interruption_notice") == [5.0]
    # proactive rebalance fired at the recommendation itself
    assert any(t == 3.0 and msg.startswith("lb") for t, msg in drv.timeline)
