"""Vertical elasticity and QoS on the port, and against the reference.

The cases of ``test_vertical.py`` that need ``repro_torch.vertical``:
the tier mapping, BestEffort held at the door until idle capacity, the
cluster's grow / shrink smoke, forced shrinks that lose no work, and the
sliding window's history, the failure detector's wedge cross-check and
the adaptive checkpoint cadence (each also against the reference's for
the same inputs), and the seeded resize / preempt / resume / step
interleaving on a dense float32 engine (the reference's hypothesis
property, ``test_resize_interleaving_property``, on fixed seeds; the
other engine-level resize cases are in
``test_torch_{workunit,simengine}.py``).  Then parity: a
``FixedThresholdVertical`` + ``QoSPolicy`` cluster and a
``SlidingWindowVertical`` one, on SimEngine and on float32 paged
granite-8b, give the reference's journal digest, summary (wall-clock
keys left out) and streams.
"""

import functools

import numpy as np
import pytest
import torch

import repro.cluster as jcluster
from repro_torch.cluster import (CheckpointPolicy, FailureDetector,
                                 InstanceType, ResizeOrder, ServingCluster,
                                 VerticalScalingPolicy)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.simengine import SimEngine, sim_token
from repro_torch.serving.workunit import PAUSED
from repro_torch.serving.workload import (BATCH, INTERACTIVE, STANDARD,
                                          SLOClass, classed_requests,
                                          synthetic_requests)
from repro_torch.vertical import (BEST_EFFORT, BURSTABLE, GUARANTEED,
                                  FixedThresholdVertical, QoSPolicy,
                                  SlidingWindowVertical, qos_for)
from tests._torch_parity import JAX, TORCH, f32_models, record

torch.set_num_threads(1)


def test_qos_tier_mapping():
    assert qos_for(INTERACTIVE) is GUARANTEED
    assert qos_for(STANDARD) is BURSTABLE
    assert qos_for(BATCH) is BEST_EFFORT
    assert qos_for(None) is BURSTABLE
    # lazily-admitted classes are BestEffort regardless of priority
    assert qos_for(SLOClass("lazy", 0, admit_lazily=True)) is BEST_EFFORT
    assert qos_for(SLOClass("low", 3)) is BEST_EFFORT


def test_qos_best_effort_holds_until_idle_capacity():
    """BestEffort arrivals hold at the door while the pool's only free
    lanes are the Guaranteed reservation; they land once load drains."""
    fleet = [InstanceType("std", speed=1.0, spot=False)]
    qos = QoSPolicy(reserve_frac=0.5)
    cl = ServingCluster(None, None, fleet, dt=1.0, batch_size=2,
                        max_seq=64, engine=SimEngine, qos=qos,
                        admission="priority", device="cpu")
    rng = np.random.default_rng(0)
    mk = lambda rid, slo, new: Request(                     # noqa: E731
        rid=rid, prompt=rng.integers(0, 200, 4).astype(np.int32),
        max_new_tokens=new, slo=slo)
    cl.submit(mk(0, INTERACTIVE, 12), at=0.0)
    cl.submit(mk(1, BATCH, 10), at=0.1)     # pool busy: must hold
    out = cl.run(max_time=500)
    assert out["completed"] == 2 and out["dropped"] == 0
    assert out["qos_guaranteed_slot_s"] > 0.0
    assert out["qos_best_effort_slot_s"] > 0.0
    # the shorter batch stream was held at the door, so it finished
    # after the longer interactive one despite arriving right behind it
    traces = cl.metrics.traces
    assert traces[1].done_t > traces[0].done_t


# ---------------------------------------------------- cluster integration
def _fleet(n):
    return [InstanceType("std", speed=1.0, spot=False)] * n


def test_cluster_vertical_grow_shrink_smoke():
    """Backlog grows the lanes, quiet shrinks them back; nothing drops
    and every stream stays deterministic."""
    qos = QoSPolicy()
    vert = FixedThresholdVertical(min_batch=1, max_batch=4, step=1,
                                  grow_backlog=10.0, shrink_backlog=2.0,
                                  cooldown=2.0, qos=qos)
    cl = ServingCluster(None, None, _fleet(2), dt=1.0, batch_size=2,
                        max_seq=64, engine=SimEngine, vertical=vert,
                        qos=qos, admission="priority", device="cpu")
    reqs = classed_requests(24, 200, seed=0)
    for i, r in enumerate(reqs):
        cl.submit(r, at=0.2 * i)
    out = cl.run(max_time=5000)
    assert out["completed"] == 24 and out["dropped"] == 0
    assert out["vertical_grows"] > 0 and out["vertical_shrinks"] > 0
    for r in reqs:
        assert list(r.out_tokens) == [sim_token(r.rid, i)
                                      for i in range(len(r.out_tokens))]


class _ForcedShrink(VerticalScalingPolicy):
    """Issue one shrink-to-one order per replica at the first decision
    tick with live work — the hostile case for conservation."""

    name = "forced"

    def __init__(self):
        self.done = set()

    def decide(self, view, now):
        orders = []
        for rep in view.replicas:
            if (rep.serving and rep.rid not in self.done
                    and rep.engine.n_active > 1):
                self.done.add(rep.rid)
                orders.append(ResizeOrder(rid=rep.rid, batch_size=1,
                                          reason="forced"))
        return orders


def test_cluster_shrink_evictions_never_lose_work():
    """A forced shrink under full load parks evicted units; the resume
    path re-admits every one of them — zero lost, streams exact."""
    cl = ServingCluster(None, None, _fleet(2), dt=1.0, batch_size=3,
                        max_seq=64, engine=SimEngine,
                        vertical=_ForcedShrink(), qos=QoSPolicy(),
                        device="cpu")
    reqs = synthetic_requests(12, 200, seed=1, prompt_len=(3, 8))
    for r in reqs:
        cl.submit(r, at=0.0)
    out = cl.run(max_time=5000)
    assert out["completed"] == 12 and out["dropped"] == 0
    assert out["vertical_shrinks"] >= 1 and out["vertical_evictions"] >= 1
    assert out["resumes"] >= out["vertical_evictions"]
    for r in reqs:
        assert list(r.out_tokens) == [sim_token(r.rid, i)
                                      for i in range(len(r.out_tokens))]


def test_sliding_window_policy_needs_history():
    """The windowed recommender never resizes on a single bursty tick."""
    qos = QoSPolicy()
    fixed = FixedThresholdVertical(grow_backlog=1.0, shrink_backlog=0.5,
                                   cooldown=0.0, qos=qos)
    windowed = SlidingWindowVertical(window=100.0, min_samples=3,
                                     grow_backlog=1.0, shrink_backlog=0.5,
                                     cooldown=0.0, qos=qos)

    class _Eng:
        batch = 2

        @staticmethod
        def backlog_tokens():
            return 100.0

    class _Rep:
        rid, model_id, serving = 0, "default", True
        engine = _Eng()

    class _View:
        replicas = [_Rep()]

        def pools(self):
            return ["default"]

        def pool(self, model_id, state="admitting"):
            return [_Rep()]

        def queued_cost(self, model_id):
            return 0.0

    assert fixed.decide(_View(), 0.0)          # instant reaction
    assert not windowed.decide(_View(), 0.0)   # 1 sample: no decision
    assert not windowed.decide(_View(), 1.0)   # 2 samples: still none
    assert windowed.decide(_View(), 2.0)       # 3 samples: acts


def test_summary_schema_zero_fills_vertical_keys():
    """Horizontal-only runs emit every vertical/QoS key zero-filled, so
    downstream JSON consumers see one stable schema."""
    cl = ServingCluster(None, None, _fleet(1), dt=1.0, batch_size=2,
                        max_seq=64, engine=SimEngine, device="cpu")
    for r in synthetic_requests(3, 200, seed=0, prompt_len=(3, 6)):
        cl.submit(r, at=0.0)
    out = cl.run(max_time=500)
    for key in ("vertical_grows", "vertical_shrinks", "vertical_evictions",
                "resize_stage_s", "qos_guaranteed_slot_s",
                "qos_burstable_slot_s", "qos_best_effort_slot_s"):
        assert key in out and out[key] == 0, key


# ------------------------------------------------ detector and checkpoints
class _Rep:
    def __init__(self, rid):
        self.rid = rid


def _wedge_scans(FD):
    """The reference case's beats and scans on detector class ``FD``."""
    fd = FD(heartbeat_interval=1.0, check_interval=1.0, suspect_after=50.0,
            confirm_after=100.0, progress_stale_after=5.0)
    rep = _Rep(0)
    fd.beat(0, 0.0, progress=10, busy=True)
    fd.beat(0, 2.0, progress=10, busy=True)      # beating, not moving
    out = [fd.scan([rep], 4.0), fd.scan([rep], 6.0)]
    fd.beat(0, 7.0, progress=11, busy=True)      # progress resumed
    out.append(fd.scan([rep], 8.0))
    fd.beat(0, 9.0, progress=11, busy=False)     # idle is healthy
    out.append(fd.scan([rep], 30.0))
    plain = FD()
    plain.beat(0, 0.0, progress=10, busy=True)
    plain.beat(0, 2.0, progress=10, busy=True)
    out.append(plain.scan([_Rep(0)], 6.0))
    return out


def test_detector_suspects_wedged_replica():
    """A replica that heartbeats but stops advancing its progress counter
    while busy is suspected, and cleared when tokens move or it goes
    idle; wedge staleness never confirms death by itself; without the
    cross-check the same silence goes unnoticed.  The reference's
    detector scans the same."""
    not_yet, wedged, resumed, idle, plain = _wedge_scans(FailureDetector)
    assert not_yet == ([], [], [])
    assert wedged[0] == [0] and wedged[2] == []
    assert resumed[1] == [0]
    assert idle == ([], [], [])
    assert plain == ([], [], [])
    assert [not_yet, wedged, resumed, idle, plain] == \
        _wedge_scans(jcluster.FailureDetector)


class _Eng:
    def __init__(self, fed):
        self._fed = fed

    def slot_requests(self):
        return [(i, None) for i in range(len(self._fed))]

    def fed_tokens(self, slot):
        return self._fed[slot]


class _Serving:
    serving = True

    def __init__(self, fed):
        self.engine = _Eng(fed)


def _cadence(Policy):
    """The reference case's intervals under policy class ``Policy``."""
    fixed = Policy(interval=10.0)
    ad = Policy(interval=10.0, adaptive=True, fault_window=60.0,
                fault_ref=1.0, tokens_ref=100.0)
    out = [fixed.next_interval([_Serving([500, 500])], 0.0),
           ad.next_interval([], 0.0),
           ad.next_interval([_Serving([150, 50])], 0.0)]
    ad.note_fault(1.0)
    ad.note_fault(2.0)
    out += [ad.next_interval([_Serving([150, 50])], 3.0),
            ad.next_interval([_Serving([150, 50])], 200.0),
            ad.next_interval([_Serving([10 ** 9])], 3.0)]
    return ad, out


def test_adaptive_checkpoint_interval():
    """Chaos and in-flight work shorten the cadence; a quiet fleet relaxes
    it; a fixed policy never moves; clamps hold at extremes.  The
    reference's policy gives the same intervals."""
    ad, (fixed, quiet, busy, chaotic, aged, clamped) = _cadence(
        CheckpointPolicy)
    assert fixed == 10.0
    assert quiet == 10.0 * ad.quiet_relax        # nothing at risk: relax
    assert busy < 10.0                           # live tokens: tighten
    assert ad.min_interval <= chaotic < busy     # chaos tightens further
    assert aged == busy                          # faults age out
    assert clamped == ad.min_interval
    with pytest.raises(ValueError, match="min <= interval <= max"):
        CheckpointPolicy(interval=1.0, min_interval=2.0, max_interval=4.0)
    assert _cadence(jcluster.CheckpointPolicy)[1] == \
        [fixed, quiet, busy, chaotic, aged, clamped]


# ------------------------------------------------------------ conservation
def _requests(n, seed=3, max_new=6):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
                0, 200, int(rng.integers(3, 20))).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n)]


@pytest.mark.parametrize(
    "seed", [int(s) for s in np.random.default_rng(2025).integers(
        0, 10_001, 6)])
def test_resize_interleaving_property_dense(f32, seed):
    """The reference's resize / preempt / resume / step interleaving on a
    dense float32 engine: every request finishes with the stream of a
    never-resized engine holding every request, resize evictions are
    parked like preemptions."""
    cfg, params = f32["torch"]
    rng = np.random.default_rng(seed)
    lone = ServingEngine(cfg, params, batch_size=6, max_seq=64,
                         device="cpu")
    want = _requests(6, seed=seed, max_new=5)
    for r in want:
        lone.submit(r)
    lone.run_until_idle()
    eng = ServingEngine(cfg, params, batch_size=3, max_seq=64, device="cpu")
    reqs = _requests(6, seed=seed, max_new=5)
    for r in reqs:
        eng.submit(r)
    paused = []
    for _ in range(rng.integers(8, 16)):
        op = rng.integers(0, 4)
        if op == 0:
            eng.step()
        elif op == 1:
            evicted = eng.resize(batch_size=int(rng.integers(1, 5)))
            assert all(u.state is PAUSED for u in evicted)
            paused.extend(evicted)
        elif op == 2:
            paused.extend(eng.preempt())
        elif op == 3 and paused:
            batch, paused = paused, []
            eng.resume(batch)
    eng.resume(paused)
    eng.run_until_idle()
    assert all(r.done for r in reqs)
    assert [list(r.out_tokens) for r in reqs] == \
        [list(r.out_tokens) for r in want]


# ------------------------------------------------- parity with repro
def _policy(p, kind):
    """``fixed``: ``FixedThresholdVertical`` with ``QoSPolicy``;
    ``window``: ``SlidingWindowVertical`` alone."""
    V = p.vertical
    kw = dict(min_batch=1, max_batch=4, step=1, grow_backlog=10.0,
              shrink_backlog=2.0, cooldown=2.0)
    if kind == "fixed":
        qos = V.QoSPolicy()
        return dict(vertical=V.FixedThresholdVertical(qos=qos, **kw),
                    qos=qos)
    return dict(vertical=V.SlidingWindowVertical(window=4.0, min_samples=2,
                                                 **kw))


def _sim_vertical_run(p, kind):
    """``test_cluster_vertical_grow_shrink_smoke``'s fleet and arrivals
    under either policy."""
    C, W = p.cluster, p.workload
    cl = C.ServingCluster(None, None, [C.InstanceType("std", 1.0,
                                                      spot=False)] * 2,
                          dt=1.0, batch_size=2, max_seq=64, engine="sim",
                          admission="priority", **_policy(p, kind),
                          **p.dev)
    reqs = W.classed_requests(24, 200, seed=0)
    for i, r in enumerate(reqs):
        cl.submit(r, at=0.2 * i)
    return record(cl, reqs, cl.run(max_time=5000))


@pytest.mark.parametrize("kind", ["fixed", "window"])
def test_sim_vertical_cluster_matches_reference(kind):
    ref, got = _sim_vertical_run(JAX, kind), _sim_vertical_run(TORCH, kind)
    s = got["summary"]
    assert s["completed"] == 24 and s["dropped"] == 0
    assert s["vertical_grows"] > 0 and s["vertical_shrinks"] > 0
    assert got == ref


@pytest.fixture(scope="module")
def f32():
    return f32_models()


def _paged_vertical_run(p, model, kind):
    """The ``cluster_vertical`` benchmark's shape at a small size: two
    non-spot replicas of 2 paged lanes, 6 batch-class requests at t = 0
    and 4 interactive ones at t = 6, resized in place by either
    policy."""
    cfg, params = model
    C, W = p.cluster, p.workload
    interactive = W.SLOClass("interactive", 0, deadline=26.0)
    batch = W.SLOClass("batch", 2, deadline=4000.0, admit_lazily=True)
    rng = np.random.default_rng(11)
    timed = []
    for rid in range(10):
        surge = rid >= 6
        timed.append((6.0 if surge else 0.0, p.engine.Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size,
                                int(rng.integers(3, 6) if surge
                                    else rng.integers(6, 10)),
                                dtype=np.int32),
            max_new_tokens=int(rng.integers(4, 7) if surge
                               else rng.integers(18, 24)),
            slo=interactive if surge else batch)))
    engine = functools.partial(p.engine.ServingEngine, cache_mode="paged",
                               block_size=8)
    cl = C.ServingCluster(cfg, params,
                          [C.InstanceType("std.1x", 1.0, spot=False)] * 2,
                          router=C.DeadlineAwareRouter(), dt=1.0,
                          batch_size=2, max_seq=48, decode_block=2,
                          admission="priority", engine=engine,
                          autoscaler_kw=dict(scale_up_backlog=1e9,
                                             slo_scale_up=False,
                                             max_replicas=2),
                          **_policy(p, kind), **p.dev)
    for at, r in timed:
        cl.submit(r, at=at)
    return record(cl, [r for _, r in timed], cl.run(max_time=10_000))


@pytest.mark.parametrize("kind", ["fixed", "window"])
def test_paged_vertical_cluster_matches_reference_f32(f32, kind):
    ref = _paged_vertical_run(JAX, f32["jax"], kind)
    got = _paged_vertical_run(TORCH, f32["torch"], kind)
    s = got["summary"]
    assert s["completed"] == 10 and s["dropped"] == 0
    assert s["vertical_grows"] > 0 and s["vertical_shrinks"] > 0
    assert got == ref
