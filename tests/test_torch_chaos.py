"""Chaos fault model + checkpoint-based recovery (paper §IV stressed).

The tentpole invariants:

* **Hard kills are survivable** — a zero-notice kill loses nothing when
  periodic checkpoints + heartbeat failure detection are on: every
  request completes, checkpointed streams continue bit-identically to a
  fault-free run, and the un-checkpointed tail re-decodes from the
  prompt to the same tokens (greedy decode is placement-independent).
* **Recovery off loses work** — the same seeded chaos soup with no
  detector demonstrably drops the killed replica's in-flight requests
  (the A/B the ``cluster_chaos`` benchmark guards in CI).
* **The rest of the soup degrades, not breaks** — slowdown scales the
  step interval, network contention delays staging and heartbeats,
  endpoint failures retry with backoff, stragglers are quarantined.

A mirror of ``test_chaos.py`` on ``repro_torch.cluster`` (reduced
granite-8b, the port's seeded weights, ``device="cpu"``).
"""

import numpy as np
import pytest

from repro_torch.cluster import (CheckpointPolicy, EndpointUnavailable,
                                 FailureDetector, HostEndpoint, InstanceType,
                                 QuarantineOrder, ReleaseOrder, Replica,
                                 ServingCluster, StragglerPolicy)
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.runtime import FaultTrace
from repro_torch.configs import get_config
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.workload import INTERACTIVE, synthetic_requests


@pytest.fixture(scope="module")
def model():
    cfg = get_config("granite-8b").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    return cfg, params


FLEET = [InstanceType("std.1x", 1.0), InstanceType("std.1x", 1.0)]


def _chaos_trace():
    """Fixed mixed soup: kill one busy replica mid-stream, slow the
    other, congest the fabric, and break the endpoint once."""
    trace = FaultTrace()
    trace.inject_hard_kill(6.0, 0)
    trace.inject_slowdown(4.0, 1, factor=3.0, duration=10.0)
    trace.inject_contention(5.0, factor=2.0, duration=8.0)
    trace.inject_endpoint_failure(2.0, 0, count=1)
    return trace


def _run(model, *, chaos, recover, n=12):
    cfg, params = model
    kw = {}
    if recover:
        kw = dict(checkpoint=CheckpointPolicy(interval=2.0),
                  health=FailureDetector(heartbeat_interval=1.0,
                                         check_interval=1.0,
                                         suspect_after=2.5,
                                         confirm_after=5.0),
                  straggler=StragglerPolicy())
    cl = ServingCluster(cfg, params, FLEET,
                        trace=_chaos_trace() if chaos else FaultTrace(),
                        dt=1.0, batch_size=2, max_seq=32, **kw, device="cpu")
    reqs = synthetic_requests(n, 200, seed=0, prompt_len=(3, 8))
    for i, r in enumerate(reqs):
        cl.submit(r, at=0.3 * i)
    out = cl.run(max_time=5000)
    return cl, reqs, out


# ------------------------------------------------------------ tentpole A/B
def test_hard_kill_with_recovery_loses_nothing(model):
    """Chaos soup + checkpoints + failure detection: zero requests lost,
    final streams bit-identical to the fault-free run."""
    _, ref_reqs, _ = _run(model, chaos=False, recover=False)
    cl, reqs, out = _run(model, chaos=True, recover=True)
    assert out["hard_kills"] == 1 and out["recoveries"] == 1
    assert out["dropped"] == 0 and out["requests_lost"] == 0
    assert out["completed"] == len(reqs)
    assert all(r.done for r in reqs)
    assert all(a.out_tokens == b.out_tokens
               for a, b in zip(ref_reqs, reqs)), \
        "recovered streams diverged from the fault-free reference"
    # the soup actually bit: checkpoints were taken, the detector fired,
    # contention delayed at least one staging leg, the endpoint retried
    assert out["checkpoints"] > 0 and out["requests_recovered"] > 0
    assert out["contention_delay_s"] > 0
    assert out["endpoint_retries"] >= 1
    assert out["recovery_latency_s"] > 0
    assert any("recover r0" in m for _, m in cl.timeline)


def test_hard_kill_without_recovery_loses_work(model):
    """Same soup, no detector/checkpoints: the killed replica's
    in-flight and queued requests are demonstrably lost (the loop
    drains — nothing keeps retrying forever)."""
    _, reqs, out = _run(model, chaos=True, recover=False)
    lost = [r for r in reqs if not r.done]
    assert lost, "expected the hard kill to strand requests"
    assert out["completed"] == len(reqs) - len(lost)
    assert out["requests_lost"] == len(lost)
    assert out["recoveries"] == 0 and out["checkpoints"] == 0


def test_chaos_run_is_deterministic(model):
    """Two identical chaos+recovery runs dispatch the identical event
    journal and produce identical streams (virtual-time determinism
    survives the whole kill/detect/recover machinery)."""
    cl_a, reqs_a, _ = _run(model, chaos=True, recover=True, n=8)
    cl_b, reqs_b, _ = _run(model, chaos=True, recover=True, n=8)
    assert cl_a.loop.journal == cl_b.loop.journal
    assert all(a.out_tokens == b.out_tokens
               for a, b in zip(reqs_a, reqs_b))


# ------------------------------------------------- S3: stale-event race
def test_stale_lifecycle_event_against_drained_replica_is_noop(model):
    """Equal-timestamp terminate-vs-drain race: a lifecycle event
    delivered against a replica that an earlier same-timestamp event
    already drained+terminated is a guarded no-op — the run completes
    with identical streams, and the schedule replays journal-identically
    run over run."""
    cfg, params = model

    def run(duplicate):
        trace = FaultTrace(rebalance_lead=0.0, notice_deadline=0.0)
        trace.inject(5.0, 0)     # all three events land at t=5.0
        if duplicate:
            # a second full lifecycle against the same victim at the
            # same instant: every event hits an already-drained replica
            trace.inject(5.0, 0)
        cl = ServingCluster(cfg, params, FLEET, trace=trace, dt=1.0,
                            batch_size=2, max_seq=32, device="cpu")
        reqs = synthetic_requests(8, 200, seed=3, prompt_len=(3, 8))
        for r in reqs:
            cl.submit(r, at=0.0)
        out = cl.run(max_time=5000)
        return cl, reqs, out

    _, ref, _ = run(False)
    cl_a, reqs_a, out_a = run(True)
    cl_b, reqs_b, _ = run(True)
    assert out_a["dropped"] == 0 and all(r.done for r in reqs_a)
    assert all(a.out_tokens == b.out_tokens for a, b in zip(ref, reqs_a))
    # only ONE drain was recorded: the duplicate lifecycle found the
    # replica already gone and changed nothing
    assert out_a["drains"] == 1
    assert cl_a.loop.journal == cl_b.loop.journal


# ---------------------------------------------------------- slowdown
def test_slowdown_scales_step_interval(model):
    cfg, params = model
    rep = Replica(0, cfg, params, InstanceType("std.2x", 2.0),
                  batch_size=2, max_seq=32, device="cpu")
    base = rep.step_interval
    rep.apply_slowdown(3.0, until=10.0)
    assert rep.step_interval == pytest.approx(3.0 * base)
    rep.clear_slowdown(now=5.0)      # before the window ends: no-op
    assert rep.step_interval == pytest.approx(3.0 * base)
    rep.apply_slowdown(3.0, until=10.0)
    rep.clear_slowdown(now=10.0)
    assert rep.step_interval == pytest.approx(base)


# ----------------------------------------------------- endpoint retries
def test_endpoint_retries_transient_failures_with_backoff(model):
    cfg, params = model
    eng = ServingEngine(cfg, params, batch_size=2, max_seq=32, device="cpu")
    req = Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                  max_new_tokens=4)
    eng.submit(req)
    eng.step()
    units = eng.pack()
    ep = HostEndpoint(max_retries=3, device="cpu")
    ep.arm_failures(2)               # transient: within the budget
    ep.put(units, "ckpt_r0")
    assert ep.retries == 2 and ep.backoff_s > 0

    ep.arm_failures(5)               # persistent: exceeds max_retries
    with pytest.raises(EndpointUnavailable):
        ep.put(units, "ckpt_r0")


# ------------------------------------------------ checkpoint mechanics
def test_checkpoint_units_is_non_destructive(model):
    """checkpoint_units observes: the engine decodes on to the same
    stream as an unobserved run, and the snapshot is frozen at the
    checkpoint (later decode does not mutate it)."""
    cfg, params = model
    prompt = np.arange(1, 8, dtype=np.int32)

    def run(observe):
        eng = ServingEngine(cfg, params, batch_size=2, max_seq=32,
                            device="cpu")
        req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
        eng.submit(req)
        for _ in range(3):
            eng.step()
        units = eng.checkpoint_units() if observe else []
        frozen = [list(u.snapshot.request.out_tokens) for u in units]
        eng.run_until_idle()
        return req, units, frozen

    ref, _, _ = run(False)
    req, units, frozen = run(True)
    assert req.done and req.out_tokens == ref.out_tokens
    assert len(units) == 1
    assert frozen[0] == list(units[0].snapshot.request.out_tokens)
    assert len(frozen[0]) < len(req.out_tokens)


def test_checkpoint_resume_restores_sampled_stream(model):
    """A temperature>0 stream checkpointed and resumed into a FRESH
    engine continues bit-identically: the snapshot carries the sampler
    rng state."""
    cfg, params = model
    prompt = np.arange(1, 10, dtype=np.int32)

    def fresh():
        return ServingEngine(cfg, params, batch_size=2, max_seq=48,
                             temperature=0.8, seed=7, device="cpu")

    ref_eng = fresh()
    ref = Request(rid=0, prompt=prompt.copy(), max_new_tokens=10)
    ref_eng.submit(ref)
    ref_eng.run_until_idle()

    eng = fresh()
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=10)
    eng.submit(req)
    for _ in range(4):
        eng.step()
    units = eng.checkpoint_units()
    assert len(units) == 1 and units[0].snapshot.rng is not None
    # the kill: the engine vanishes; the checkpointed unit resumes on a
    # fresh engine, rewound to the checkpoint
    resumed = units[0].snapshot.request
    eng2 = fresh()
    eng2.unpack(units)
    eng2.run_until_idle()
    assert resumed.done
    assert list(resumed.out_tokens) == list(ref.out_tokens)


# ------------------------------------------------------ failure detector
def test_failure_detector_ladder():
    class Rep:
        def __init__(self, rid):
            self.rid = rid

    det = FailureDetector(heartbeat_interval=1.0, check_interval=1.0,
                          suspect_after=3.0, confirm_after=6.0)
    reps = [Rep(0), Rep(1)]
    det.beat(0, 0.0)
    det.beat(1, 0.0)
    assert det.scan(reps, 1.0) == ([], [], [])
    det.beat(1, 3.5)                         # r1 keeps beating
    suspects, cleared, confirmed = det.scan(reps, 4.0)
    assert suspects == [0] and not cleared and not confirmed
    det.beat(0, 4.5)                         # late beat (contention)
    suspects, cleared, confirmed = det.scan(reps, 5.0)
    assert not suspects and cleared == [0] and not confirmed
    suspects, cleared, confirmed = det.scan(reps, 11.0)
    assert [r.rid for r in confirmed] == [0, 1]
    assert det.scan(reps, 20.0) == ([], [], [])   # forgotten once confirmed
    with pytest.raises(ValueError):
        FailureDetector(suspect_after=5.0, confirm_after=5.0)


# ------------------------------------------------------- straggler policy
class _FakeEngine:
    def __init__(self, slots):
        self._slots = slots

    @property
    def n_active(self):
        return len(self._slots)

    def slot_requests(self):
        return list(enumerate(self._slots))


class _FakeReplica:
    def __init__(self, rid, slots=()):
        self.rid = rid
        self.serving = True
        self.model_id = "m"
        self.quarantined = False
        self.quarantined_t = 0.0
        self.engine = _FakeEngine(list(slots))


class _FakeView:
    def __init__(self, replicas, rates):
        self.replicas = replicas
        self._rates = rates

    def rates(self):
        return self._rates


def test_straggler_policy_quarantines_and_releases():
    urgent = Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4,
                     slo=INTERACTIVE)
    urgent.arrival_t = 0.0          # a finite deadline needs an arrival
    lazy = Request(rid=1, prompt=[1, 2, 3], max_new_tokens=4)
    straggler = _FakeReplica(0, slots=[urgent, lazy])
    healthy = [_FakeReplica(1), _FakeReplica(2)]
    view = _FakeView([straggler] + healthy,
                     {0: 0.2, 1: 1.0, 2: 1.0})
    pol = StragglerPolicy(threshold=0.5, min_fleet=2, probe_after=30.0)
    orders = pol.orders(view, now=10.0)
    assert len(orders) == 1 and isinstance(orders[0], QuarantineOrder)
    assert orders[0].rid == 0
    assert orders[0].slots == (0,)           # only the urgent slot moves

    straggler.quarantined = True
    straggler.quarantined_t = 10.0
    # rate recovers -> release by measurement
    view._rates[0] = 0.9
    orders = pol.orders(view, now=15.0)
    assert [type(o) for o in orders] == [ReleaseOrder]
    # still slow but drained: released by the idle probe, not benched
    view._rates[0] = 0.0
    straggler.engine._slots = []
    assert pol.orders(view, now=15.0) == []          # probe not yet due
    orders = pol.orders(view, now=41.0)
    assert [type(o) for o in orders] == [ReleaseOrder]


# --------------------------------------------------- S6: metrics schema
def test_summary_zero_fills_recovery_counters():
    """A fresh fleet summary carries every chaos/recovery key at zero —
    downstream dashboards never KeyError on a quiet run."""
    s = ClusterMetrics().summary(1.0)
    for key in ("hard_kills", "requests_lost", "requests_recovered",
                "recoveries", "replayed_tokens", "recovery_latency_s",
                "recovery_restore_s", "checkpoints", "checkpointed_units",
                "checkpoint_stage_s", "slowdowns", "contention_windows",
                "contention_delay_s", "endpoint_faults",
                "endpoint_retries", "retry_backoff_s", "quarantines"):
        assert s[key] == 0, key
