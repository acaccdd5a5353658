"""SLO scheduling layer on the port: priority admission, deadline
routing, mid-stream migration, multi-model fleets, closed-loop offered
load.  A mirror of ``test_cluster_slo.py`` on ``repro_torch.cluster``
(reduced configs, the port's seeded weights, ``device="cpu"``).

The acceptance bar (paper §III/§IV + the elastic-job-scheduler deadline
layer):

* batch-class arrivals are *held* while the fleet lacks backlog headroom
  and admitted when it opens — interactive work is never held;
* the deadline-aware router strictly improves interactive deadline
  attainment and p99 latency over FIFO rate-aware on the same seeded
  arrival/fault trace, with bit-identical per-request tokens;
* the recurring ``rebalance`` event moves in-flight slots off
  overloaded/slow replicas through the snapshot/restore path, losing no
  token;
* replicas belong to per-model pools; routing, readmission and
  autoscaling never cross pools;
* a closed-loop think-time process keeps at most ``n_users`` requests in
  flight — offered load tracks completions.
"""

import math

import numpy as np
import pytest

from repro_torch.cluster import (DeadlineAwareRouter, InstanceType,
                                 RateAwareRouter, ServingCluster)
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.configs import get_config
from repro_torch.models import model_zoo as zoo
from repro_torch.runtime import FaultTrace
from repro_torch.serving.engine import Request
from repro_torch.serving.workload import (BATCH, INTERACTIVE, STANDARD,
                                          ClosedLoopThinkTime, PoissonArrivals,
                                          SLOClass, classed_requests,
                                          synthetic_requests)


@pytest.fixture(scope="module")
def model():
    cfg = get_config("granite-8b").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    return cfg, params


@pytest.fixture(scope="module")
def ssm_model():
    cfg = get_config("mamba2-780m").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    return cfg, params


FLEET = [InstanceType("fast.2x", 2.0), InstanceType("fast.2x", 2.0),
         InstanceType("slow.1x", 0.7), InstanceType("slow.1x", 0.7)]

TIGHT = SLOClass("interactive", 0, deadline=12.0)
LOOSE = SLOClass("batch", 2, deadline=400.0, admit_lazily=True)


def _mixed_requests(cfg, n=24, seed=0):
    return classed_requests(n, cfg.vocab_size, interactive_frac=0.5,
                            seed=seed, interactive=TIGHT, batch=LOOSE)


def _run(model, *, slo_aware, n=24, rate=2.0, interrupt=True,
         rebalance_interval=2.0, **kw):
    cfg, params = model
    trace = FaultTrace(rebalance_lead=6.0, notice_deadline=4.0)
    if interrupt:
        trace.inject(4.0, 0)
    base = dict(dt=1.0, batch_size=2, max_seq=48, trace=trace, device="cpu")
    base.update(kw)
    if slo_aware:
        cl = ServingCluster(cfg, params, FLEET,
                            router=DeadlineAwareRouter(),
                            admission="priority",
                            batch_admit_headroom=24.0,
                            rebalance_interval=rebalance_interval, **base)
    else:
        cl = ServingCluster(cfg, params, FLEET,
                            router=RateAwareRouter(), **base)
    reqs = _mixed_requests(cfg, n=n)
    cl.attach_arrivals(PoissonArrivals(reqs, rate, seed=0))
    out = cl.run(max_time=10_000)
    return cl, reqs, out


# ----------------------------------------------------------- A/B headline
def test_slo_aware_beats_fifo_on_interactive_attainment(model):
    """The tentpole claim, at test scale: same seeded arrivals + fault
    trace, strictly better interactive attainment AND p99, identical
    decoded tokens, nothing dropped."""
    _, fifo_reqs, fifo = _run(model, slo_aware=False)
    cl, slo_reqs, slo = _run(model, slo_aware=True)
    assert fifo["dropped"] == 0 and slo["dropped"] == 0
    assert slo["attainment_interactive"] > fifo["attainment_interactive"]
    assert (slo["p99_latency_interactive"]
            < fifo["p99_latency_interactive"])
    # greedy decode is placement/migration-independent: the SLO layer may
    # only reorder *time*, never change tokens
    for a, b in zip(fifo_reqs, slo_reqs):
        assert a.out_tokens == b.out_tokens, a.rid
    # and the rebalancer actually exercised mid-stream migration
    assert slo["rebalance_migrations"] > 0
    assert any("rebalance req" in msg for _, msg in cl.timeline)


def test_slo_run_is_deterministic(model):
    runs = [_run(model, slo_aware=True) for _ in range(2)]
    (cl_a, _, out_a), (cl_b, _, out_b) = runs
    assert cl_a.loop.journal == cl_b.loop.journal
    assert cl_a.timeline == cl_b.timeline
    drop = "interruption_overhead_s"
    assert ({k: v for k, v in out_a.items() if k != drop}
            == {k: v for k, v in out_b.items() if k != drop})


# ----------------------------------------------------- priority admission
def test_priority_admission_holds_batch_until_headroom(model):
    """With a tiny headroom, batch arrivals wait at the door while
    interactive arrivals are admitted immediately; held work is admitted
    later (nothing starves) once backlog drains."""
    cfg, params = model
    cl = ServingCluster(cfg, params, FLEET[:2],
                        router=DeadlineAwareRouter(),
                        admission="priority", batch_admit_headroom=4.0,
                        dt=1.0, batch_size=2, max_seq=48, device="cpu")
    reqs = _mixed_requests(cfg, n=16, seed=3)
    for r in reqs:
        cl.submit(r, at=0.0)
    out = cl.run(max_time=10_000)
    held = [msg for _, msg in cl.timeline if msg.startswith("hold req")]
    admitted = [msg for _, msg in cl.timeline
                if msg.startswith("admit req")]
    assert held, "no batch request was ever held"
    assert len(admitted) == len(held), "held work starved"
    for msg in held:
        assert "(batch" in msg          # only the lazy class is held
    assert out["completed"] == len(reqs) and out["dropped"] == 0


def test_fifo_admission_never_holds(model):
    cfg, params = model
    cl = ServingCluster(cfg, params, FLEET[:2], router=RateAwareRouter(),
                        dt=1.0, batch_size=2, max_seq=48,
                        batch_admit_headroom=0.1,   # ignored under fifo
                        device="cpu")
    for r in _mixed_requests(cfg, n=8, seed=4):
        cl.submit(r, at=0.0)
    out = cl.run(max_time=10_000)
    assert not any(msg.startswith("hold req") for _, msg in cl.timeline)
    assert out["completed"] == 8


# ------------------------------------------------------- deadline routing
def _stub_target(free_slots=0, slot_costs=(), restores=()):
    """A replica stand-in exposing just what ``_slot_free_times`` reads."""
    from types import SimpleNamespace
    eng = SimpleNamespace(
        free_slots=free_slots,
        slot_costs=lambda: [(i, c) for i, c in enumerate(slot_costs)],
        restore_costs=lambda discount=None: list(restores))
    return SimpleNamespace(engine=eng)


def test_deadline_router_repairs_predicted_misses(model):
    """A request that GreedyRefine would leave behind a long-running
    slot on the fast replica is relocated when that placement predicts
    a deadline miss the other replica's free slot avoids."""
    router = DeadlineAwareRouter()
    pending = [Request(rid=0, prompt=np.zeros(3, np.int32),
                       max_new_tokens=10, slo=TIGHT, arrival_t=0.0)]
    loads = np.asarray([10.0])
    rate = np.asarray([2.0, 1.0])
    base = np.asarray([200.0, 0.0])
    deadlines = np.asarray([12.0])
    # fast replica: every slot busy for 100s; slow replica: a free slot
    targets = [_stub_target(slot_costs=[200.0]), _stub_target(free_slots=1)]
    slot_free = router._slot_free_times(targets, rate)
    assert slot_free == [[100.0], [0.0]]
    # pinned to the fast-but-fully-busy replica: predicted miss
    miss, missed = router._predicted_misses(
        np.asarray([0]), loads, rate, slot_free, deadlines, now=0.0)
    assert miss == 1 and missed == [0]
    fixed = router._refine_assignment(
        np.asarray([0]), targets, pending, loads, rate, base, now=0.0)
    assert fixed[0] == 1                # moved to the idle slow replica
    miss, _ = router._predicted_misses(
        fixed, loads, rate, slot_free, deadlines, now=0.0)
    assert miss == 0


def test_deadline_router_slot_level_parallelism():
    """Two free slots serve two queued requests in parallel: the old
    serial model predicted the second request missing (10s + 10s > 15s
    deadline); the slot-level EDF simulation predicts zero misses — and
    restore-queue units claim slots ahead of fresh work."""
    router = DeadlineAwareRouter()
    rate = np.asarray([1.0])
    loads = np.asarray([10.0, 10.0])
    deadlines = np.asarray([15.0, 15.0])
    slot_free = router._slot_free_times([_stub_target(free_slots=2)], rate)
    assert slot_free == [[0.0, 0.0]]
    miss, _ = router._predicted_misses(
        np.asarray([0, 0]), loads, rate, slot_free, deadlines, now=0.0)
    assert miss == 0
    # a restore-queue unit occupies the earliest slot first
    (free,) = router._slot_free_times(
        [_stub_target(free_slots=2, restores=[8.0])], rate)
    assert sorted(free) == [0.0, 8.0]
    miss, missed = router._predicted_misses(
        np.asarray([0, 0]), loads, rate, [free], deadlines, now=0.0)
    assert miss == 1 and missed == [1]   # 8 + 10 > 15: one slot is late


def test_deadline_router_orders_by_priority_then_deadline():
    router = DeadlineAwareRouter()
    mk = (lambda rid, slo, t: Request(rid=rid,
                                      prompt=np.zeros(3, np.int32),
                                      slo=slo, arrival_t=t))
    batch = mk(0, LOOSE, 0.0)
    late_int = mk(1, TIGHT, 5.0)
    early_int = mk(2, TIGHT, 1.0)
    ordered = router._order_pending([batch, late_int, early_int])
    assert [r.rid for r in ordered] == [2, 1, 0]


# ---------------------------------------------------- mid-stream migration
def test_rebalance_moves_slots_and_loses_no_tokens(model):
    """Force a skewed placement (round-robin is rate-oblivious), enable
    the rebalancer, and check slots migrate off the slow replica with
    bit-identical output vs an unbalanced run."""
    from repro_torch.cluster import RoundRobinRouter
    cfg, params = model
    fleet = [InstanceType("fast.4x", 4.0),
             InstanceType("slow.1x", 0.5)]
    outs = {}
    for interval in (None, 2.0):
        cl = ServingCluster(cfg, params, fleet,
                            router=RoundRobinRouter(), dt=1.0,
                            batch_size=2, max_seq=48,
                            rebalance_interval=interval, device="cpu")
        reqs = synthetic_requests(8, cfg.vocab_size, seed=5,
                                  prompt_len=(3, 8), max_new=(20, 28))
        for r in reqs:
            cl.submit(r, at=0.0)
        out = cl.run(max_time=10_000)
        outs[interval] = (cl, reqs, out)
        assert out["completed"] == 8 and out["dropped"] == 0
    cl_off, reqs_off, out_off = outs[None]
    cl_on, reqs_on, out_on = outs[2.0]
    assert out_off["rebalance_migrations"] == 0
    assert out_on["rebalance_migrations"] > 0
    for a, b in zip(reqs_off, reqs_on):
        assert a.out_tokens == b.out_tokens, a.rid
    # migrating work off the slow replica must not be a pessimization
    assert out_on["virtual_seconds"] <= out_off["virtual_seconds"]
    assert any(msg.startswith("rebalance req")
               for _, msg in cl_on.timeline)


def test_rebalance_respects_balanced_fleets(model):
    """A homogeneous, evenly-loaded fleet sees no spurious migrations."""
    cfg, params = model
    fleet = [InstanceType("base", 1.0), InstanceType("base", 1.0)]
    cl = ServingCluster(cfg, params, fleet, router=RateAwareRouter(),
                        dt=1.0, batch_size=2, max_seq=48,
                        rebalance_interval=1.0, device="cpu")
    reqs = synthetic_requests(8, cfg.vocab_size, seed=6,
                              prompt_len=(4, 5), max_new=12)
    for r in reqs:
        cl.submit(r, at=0.0)
    out = cl.run(max_time=10_000)
    assert out["completed"] == 8
    assert out["rebalance_migrations"] == 0


# -------------------------------------------------------- multi-model fleet
def test_multi_model_fleet_routes_and_scales_per_pool(model, ssm_model):
    """Two model pools (causal + ssm) share one cluster: requests only
    land on their own pool's replicas, both pools complete, and tokens
    per request match a single-model run of the same pool."""
    cfg_a, params_a = model
    cfg_b, params_b = ssm_model
    fleet = [InstanceType("a.fast", 2.0, model_id="granite"),
             InstanceType("a.slow", 1.0, model_id="granite"),
             InstanceType("b.fast", 2.0, model_id="mamba"),
             InstanceType("b.slow", 1.0, model_id="mamba")]
    cl = ServingCluster(cfg_a, params_a, fleet,
                        router=DeadlineAwareRouter(),
                        models={"granite": (cfg_a, params_a),
                                "mamba": (cfg_b, params_b)},
                        dt=1.0, batch_size=2, max_seq=48, device="cpu")
    vocab = min(cfg_a.vocab_size, cfg_b.vocab_size)
    reqs = synthetic_requests(12, vocab, seed=7, prompt_len=(3, 8))
    for i, r in enumerate(reqs):
        r.model_id = "granite" if i % 2 == 0 else "mamba"
        cl.submit(r, at=0.0)
    out = cl.run(max_time=10_000)
    assert out["completed"] == 12 and out["dropped"] == 0
    # replicas only ever served their own pool
    by_model = {"granite": {0, 1}, "mamba": {2, 3}}
    for rep in cl.replicas:
        assert rep.rid in by_model[rep.model_id]
    # single-model reference runs reproduce each pool's tokens exactly
    for model_id, (cfg_m, params_m) in (("granite", (cfg_a, params_a)),
                                        ("mamba", (cfg_b, params_b))):
        sub = [r for r in reqs if r.model_id == model_id]
        ref_cl = ServingCluster(
            cfg_m, params_m,
            [InstanceType("x", 2.0), InstanceType("y", 1.0)],
            router=RateAwareRouter(), dt=1.0, batch_size=2, max_seq=48,
            device="cpu")
        refs = synthetic_requests(12, vocab, seed=7, prompt_len=(3, 8))
        for i, r in enumerate(refs):
            if (("granite" if i % 2 == 0 else "mamba") == model_id):
                ref_cl.submit(r, at=0.0)
        ref_cl.run(max_time=10_000)
        for a in sub:
            b = next(r for r in refs if r.rid == a.rid)
            assert a.out_tokens == b.out_tokens, (model_id, a.rid)


def test_unserved_model_requests_wait_not_crash(model):
    """A request for a pool with no admitting replica stays queued (and
    the run simply times out with it pending) instead of crashing or
    being mis-placed."""
    cfg, params = model
    cl = ServingCluster(cfg, params, [InstanceType("a", 1.0)],
                        router=DeadlineAwareRouter(), dt=1.0,
                        batch_size=2, max_seq=48, device="cpu")
    good = Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                   max_new_tokens=4)
    orphan = Request(rid=1, prompt=np.arange(4, dtype=np.int32),
                     max_new_tokens=4, model_id="missing")
    cl.submit(good, at=0.0)
    cl.submit(orphan, at=0.0)
    out = cl.run(max_time=50)
    assert good.done
    assert not orphan.done and orphan in cl.router.queue


# ------------------------------------------------------------ closed loop
def test_closed_loop_offered_load_tracks_completions():
    """Unit: arrivals beyond the initial ``n_users`` are re-armed one per
    completion, strictly after it."""
    reqs = synthetic_requests(6, 100, seed=8)
    proc = ClosedLoopThinkTime(reqs, n_users=2, think_mean=0.5, seed=1)
    first = proc.initial()
    assert [r.rid for _, r in first] == [0, 1]
    t = 1.0
    in_flight = len(first)
    while True:
        done_req = reqs[len(proc.completed)]
        nxt = proc.on_complete(done_req, t)
        in_flight -= 1
        if nxt is None:
            break
        t_next, r = nxt
        assert t_next >= t            # re-armed after the completion
        in_flight += 1
        assert in_flight <= proc.n_users
        t = t_next + 0.5
    assert len(proc.issued) == len(reqs)
    # every post-initial arrival pairs with the completion that armed it
    for (t_done, _), (t_arr, _) in zip(proc.completed,
                                       proc.issued[proc.n_users:]):
        assert t_arr >= t_done


def test_closed_loop_cluster_never_exceeds_n_users(model):
    cfg, params = model
    cl = ServingCluster(cfg, params, FLEET[:2], router=RateAwareRouter(),
                        dt=1.0, batch_size=2, max_seq=48, device="cpu")
    reqs = synthetic_requests(10, cfg.vocab_size, seed=9,
                              prompt_len=(3, 8))
    proc = ClosedLoopThinkTime(reqs, n_users=3, think_mean=1.0, seed=2)
    cl.attach_closed_loop(proc)
    out = cl.run(max_time=10_000)
    assert out["completed"] == 10 and out["dropped"] == 0
    # offered load tracked completions: at every arrival instant the
    # in-flight population (arrived, not yet done) stayed <= n_users
    traces = sorted(cl.metrics.traces.values(), key=lambda t: t.arrival_t)
    for tr in traces:
        in_flight = sum(
            1 for o in traces
            if o.arrival_t <= tr.arrival_t
            and (o.done_t is None or o.done_t > tr.arrival_t))
        assert in_flight <= proc.n_users, tr.rid


def test_closed_loop_ignores_foreign_completions(model):
    """Mixed traffic: completions of directly-submitted (non-session)
    requests must NOT re-arm the closed loop — sessions free only when
    their own request completes, so in-flight session population stays
    <= n_users throughout."""
    cfg, params = model
    cl = ServingCluster(cfg, params, FLEET[:2], router=RateAwareRouter(),
                        dt=1.0, batch_size=2, max_seq=48, device="cpu")
    session_reqs = synthetic_requests(6, cfg.vocab_size, seed=10,
                                      prompt_len=(3, 6))
    proc = ClosedLoopThinkTime(session_reqs, n_users=2, think_mean=1.0,
                               seed=3)
    cl.attach_closed_loop(proc)
    foreign = synthetic_requests(6, cfg.vocab_size, seed=11,
                                 prompt_len=(3, 6), start_rid=100)
    for r in foreign:
        cl.submit(r, at=0.0)
    out = cl.run(max_time=10_000)
    assert out["completed"] == 12 and out["dropped"] == 0
    # only session completions appear in the process's log (order may
    # interleave across sessions)
    assert {rid for _, rid in proc.completed} == {r.rid
                                                  for r in session_reqs}
    session_traces = sorted(
        (cl.metrics.traces[r.rid] for r in session_reqs),
        key=lambda t: t.arrival_t)
    for tr in session_traces:
        in_flight = sum(
            1 for o in session_traces
            if o.arrival_t <= tr.arrival_t
            and (o.done_t is None or o.done_t > tr.arrival_t))
        assert in_flight <= proc.n_users, tr.rid


# ---------------------------------------------------------------- metrics
def test_metrics_attainment_and_overdue():
    m = ClusterMetrics()
    m.on_submit(0, 0.0, slo="interactive", deadline_t=10.0)
    m.on_submit(1, 0.0, slo="interactive", deadline_t=10.0)
    m.on_submit(2, 0.0, slo="batch", deadline_t=100.0)
    m.on_done(0, 5.0, tokens=4)         # met
    m.on_done(1, 20.0, tokens=4)        # missed (late)
    assert m.class_attainment("interactive") == 0.5
    assert m.class_attainment("batch") == 0.0   # incomplete = missed
    assert m.overdue(now=50.0) == {}            # batch not yet overdue
    assert m.overdue(now=150.0) == {"batch": 1}
    s = m.summary(now=150.0)
    assert s["attainment_interactive"] == 0.5
    assert s["misses_interactive"] == 1
    assert s["misses_batch"] == 1
    assert m.class_attainment("nope") is None


def test_request_deadline_helper():
    r = Request(rid=0, prompt=np.zeros(2, np.int32), slo=TIGHT)
    assert r.deadline_t() == math.inf       # not arrived yet
    r.arrival_t = 3.0
    assert r.deadline_t() == pytest.approx(15.0)
    assert Request(rid=1, prompt=np.zeros(2, np.int32),
                   slo=STANDARD, arrival_t=0.0).deadline_t() == math.inf
    assert INTERACTIVE.priority < STANDARD.priority < BATCH.priority
    assert BATCH.admit_lazily and not INTERACTIVE.admit_lazily
