"""Router queue mechanics after the deque rewrite: FIFO admission
order, O(len) requeue that used to be O(queue^2), constant-time
queued-load aggregates, the topology-epoch pool cache, and the
``place_cap`` bounded dispatch mode the million-request matrix runs
under — all without changing a single placement decision (journal
bit-identity is pinned in tests/test_shapes.py on a full cluster run).

A mirror of ``test_router_queue.py`` on ``repro_torch.cluster`` over
the port's ``SimEngine``; the journal pin is in
``tests/test_torch_shapes.py``.
"""

import numpy as np
import pytest

from repro_torch.cluster.replica import InstanceType, Replica, ReplicaState
from repro_torch.cluster.router import (DeadlineAwareRouter, RateAwareRouter,
                                        RoundRobinRouter, request_cost)
from repro_torch.serving.engine import Request
from repro_torch.serving.simengine import SimEngine


def _req(rid, plen=6, new=4, model_id="default"):
    return Request(rid=rid,
                   prompt=np.arange(plen, dtype=np.int32) % 17,
                   max_new_tokens=new, model_id=model_id)


def _rep(rid, model_id="default", batch_size=4, speed=4.0):
    return Replica(rid, None, None,
                   InstanceType("std.1x", speed, spot=False,
                                model_id=model_id),
                   batch_size=batch_size, max_seq=64,
                   engine_cls=SimEngine, device="cpu")


# -------------------------------------------------------------- ordering
def test_submit_is_fifo():
    router = RoundRobinRouter()
    for i in range(5):
        router.submit(_req(i))
    assert [r.rid for r in router.queue] == [0, 1, 2, 3, 4]


def test_requeue_prepends_preserving_relative_order():
    router = RoundRobinRouter()
    for i in (10, 11):
        router.submit(_req(i))
    router.requeue([_req(0), _req(1), _req(2)])
    assert [r.rid for r in router.queue] == [0, 1, 2, 10, 11]
    router.requeue([_req(90)])
    assert [r.rid for r in router.queue] == [90, 0, 1, 2, 10, 11]


def test_round_robin_dispatch_drains_in_fifo_order():
    router = RoundRobinRouter()
    rep = _rep(0, batch_size=8)
    for i in range(6):
        router.submit(_req(i))
    woken = router.dispatch([rep], rates={}, now=0.0)
    assert woken == [rep]
    assert [r.rid for r in rep.engine.queued_requests()] == list(range(6))
    assert not router.queue


# ------------------------------------------------------- load aggregates
@pytest.mark.parametrize("router_cls", [RoundRobinRouter, RateAwareRouter,
                                        DeadlineAwareRouter])
def test_queued_aggregates_match_a_fresh_scan(router_cls):
    router = router_cls()
    discount = getattr(router, "prefill_discount", 1.0)
    reqs = [_req(i, plen=3 + i % 5, new=2 + i % 7,
                 model_id="m0" if i % 3 else "m1") for i in range(40)]
    for r in reqs:
        router.submit(r)
    for model_id in (None, "m0", "m1"):
        in_model = [r for r in router.queue
                    if model_id is None or r.model_id == model_id]
        assert router.queued_tokens(model_id) == pytest.approx(
            sum(r.total_tokens for r in in_model))
        assert router.queued_cost(model_id) == pytest.approx(
            sum(request_cost(r, discount) for r in in_model))


def test_queued_aggregates_survive_dispatch_and_requeue():
    router = RateAwareRouter()
    rep = _rep(0, batch_size=4)
    for i in range(10):
        router.submit(_req(i))
    router.dispatch([rep], rates={rep.rid: 4.0}, now=0.0)
    router.requeue([_req(50), _req(51)])
    discount = router.prefill_discount
    assert router.queued_cost() == pytest.approx(
        sum(request_cost(r, discount) for r in router.queue))
    assert router.queued_tokens() == pytest.approx(
        sum(r.total_tokens for r in router.queue))


def test_queued_aggregates_never_go_negative():
    router = RoundRobinRouter()
    req = _req(0)
    router.submit(req)
    router._q_rem(req)
    router._q_rem(req)            # float drift / double-remove clamps at 0
    assert router.queued_tokens() == 0.0
    assert router.queued_cost() == 0.0


# ------------------------------------------------------ pool-index cache
def test_pool_cache_rebuilds_on_topology_epoch_bump():
    router = RoundRobinRouter()
    reps = [_rep(0), _rep(1)]
    pools = router.pools(reps)
    assert [r.rid for r in pools["default"]] == [0, 1]
    assert router.pools(reps) is pools          # cached: same object back
    reps[1].state = ReplicaState.DRAINING       # bumps the epoch
    pools2 = router.pools(reps)
    assert pools2 is not pools
    assert [r.rid for r in pools2["default"]] == [0]
    reps[0].quarantined = True                  # quarantine also bumps
    assert "default" not in router.pools(reps)


# --------------------------------------------------- place_cap fast path
def test_place_cap_fills_engine_headroom_only():
    """Bounded mode never reclaims or over-places: engines receive at
    most their free-slot headroom, the rest of the backlog stays in
    the router deque in FIFO order."""
    router = RateAwareRouter(place_cap=8)
    reps = [_rep(0, batch_size=2), _rep(1, batch_size=2)]
    for i in range(10):
        router.submit(_req(i))
    woken = router.dispatch(reps, rates={0: 4.0, 1: 4.0}, now=0.0)
    assert set(w.rid for w in woken) == {0, 1}
    placed = sorted(r.rid for rep in reps
                    for r in rep.engine.queued_requests())
    assert placed == [0, 1, 2, 3]               # head of the queue
    assert [r.rid for r in router.queue] == [4, 5, 6, 7, 8, 9]
    # engines hold only their headroom: nothing queued beyond slots
    for rep in reps:
        assert rep.engine.n_queued <= rep.engine.free_slots
    # second pass with zero headroom places nothing
    assert router.dispatch(reps, rates={0: 4.0, 1: 4.0}, now=0.0) == []
    assert len(router.queue) == 6


def test_place_cap_scan_window_bounds_work_per_pass():
    router = RateAwareRouter(place_cap=3)
    rep = _rep(0, batch_size=8)
    for i in range(10):
        router.submit(_req(i))
    router.dispatch([rep], rates={rep.rid: 4.0}, now=0.0)
    # only the cap-sized head window was considered this pass
    assert [r.rid for r in rep.engine.queued_requests()] == [0, 1, 2]
    assert [r.rid for r in router.queue] == [3, 4, 5, 6, 7, 8, 9]


def test_place_cap_keeps_aggregates_consistent():
    router = RateAwareRouter(place_cap=4)
    rep = _rep(0, batch_size=4)
    for i in range(8):
        router.submit(_req(i))
    router.dispatch([rep], rates={rep.rid: 4.0}, now=0.0)
    assert router.queued_cost() == pytest.approx(
        sum(request_cost(r, router.prefill_discount)
            for r in router.queue))


def test_place_cap_respects_model_pools():
    router = RateAwareRouter(place_cap=8)
    rep_a = _rep(0, model_id="a", batch_size=4)
    for i in range(4):
        router.submit(_req(i, model_id="a" if i % 2 == 0 else "b"))
    router.dispatch([rep_a], rates={0: 4.0}, now=0.0)
    assert [r.rid for r in rep_a.engine.queued_requests()] == [0, 2]
    # pool-less requests stay queued (and stay counted)
    assert [r.rid for r in router.queue] == [1, 3]
    assert router.queued_tokens("b") > 0.0
