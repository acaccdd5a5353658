"""The serving cluster on the port, and against the reference.

A mirror of ``test_cluster.py`` on ``repro_torch.cluster`` (reduced
configs, the port's seeded weights, ``device="cpu"``), with the
``Replica`` cases of ``test_migration.py`` and the replica and cluster
cases of ``test_workunit.py``.  The paper's claims transplanted onto
serving:
  §III  rate-aware GreedyRefine routing beats rate-oblivious round-robin
        on a heterogeneous (2-fast / 2-slow) fleet;
  §IV   a spot interruption is drained proactively: every in-flight slot
        is checkpointed and re-admitted elsewhere, zero requests dropped,
        and the decoded continuations are bit-identical to an
        uninterrupted run.

Then parity: one seeded scenario runs through ``repro.cluster`` and
``repro_torch.cluster`` (the JAX weights carried over by
``params_from_numpy``) and gives the same ``EventLoop.journal_digest``,
the same timeline and the same ``summary()`` with the five wall-clock
keys left out: a ``SimEngine`` fleet with two interruptions and a
rebalance pass; float32 granite-8b on dense engines and on paged ones
(through the ``engine=`` factory seam), with equal greedy streams per
request; and a chaos soup with checkpoints and the failure detector.
"""

import functools

import numpy as np
import pytest
import torch

import repro_torch.serving.workload as tworkload
from repro_torch.cluster import (CostAwareScaling, DeviceEndpoint,
                                 HostEndpoint, InstanceType,
                                 RateAwareRouter, Replica, ReplicaState,
                                 RoundRobinRouter, ServingCluster,
                                 SLOPreemption, make_endpoint)
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.configs import get_config
from repro_torch.core import loadbalance as lb
from repro_torch.models import model_zoo as zoo
from repro_torch.runtime import SpotEventFeed
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.simengine import SimEngine
from repro_torch.serving.workload import SLOClass

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def model():
    cfg = get_config("granite-8b").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    return cfg, params


HETERO_FLEET = [InstanceType("fast.2x", 2.0), InstanceType("fast.2x", 2.0),
                InstanceType("slow.1x", 0.7), InstanceType("slow.1x", 0.7)]


def make_requests(n=16, seed=0):
    return tworkload.synthetic_requests(n, 200, seed=seed, prompt_len=(3, 8))


def run_cluster(model, router, *, interrupt_at=None, n=16, **kw):
    cfg, params = model
    cl = ServingCluster(cfg, params, HETERO_FLEET, router=router, dt=1.0,
                        batch_size=2, max_seq=32, device="cpu", **kw)
    reqs = make_requests(n)
    for r in reqs:
        cl.submit(r, at=0.0)
    if interrupt_at is not None:
        cl.inject_interruption(t=interrupt_at, replica_rid=0)
    out = cl.run(max_time=5000)
    return cl, reqs, out


# ----------------------------------------------------------------- routing
def test_rate_aware_beats_round_robin(model):
    _, _, rr = run_cluster(model, RoundRobinRouter())
    _, _, ra = run_cluster(model, RateAwareRouter())
    assert rr["dropped"] == 0 and ra["dropped"] == 0
    # makespan: the fleet drains strictly sooner under rate-aware routing
    assert ra["virtual_seconds"] < rr["virtual_seconds"], (ra, rr)
    assert ra["p99_latency"] < rr["p99_latency"], (ra, rr)
    assert ra["tok_per_s"] > rr["tok_per_s"], (ra, rr)


def test_virtual_clock_is_deterministic(model):
    _, _, a = run_cluster(model, RateAwareRouter())
    _, _, b = run_cluster(model, RateAwareRouter())
    assert a == b


def test_measured_rates_track_heterogeneity(model):
    cl, _, _ = run_cluster(model, RateAwareRouter())
    rates = cl.rates()
    fast = [rates[r.rid] for r in cl.replicas if r.itype.speed > 1]
    slow = [rates[r.rid] for r in cl.replicas if r.itype.speed < 1]
    assert min(fast) > max(slow), rates


# ----------------------------------------------------------------- drain
def test_interruption_drain_loses_nothing(model):
    _, base_reqs, _ = run_cluster(model, RateAwareRouter())
    cl, reqs, out = run_cluster(model, RateAwareRouter(), interrupt_at=3.0,
                                rebalance_lead=6.0, notice_deadline=4.0)
    assert out["dropped"] == 0
    assert out["completed"] == len(reqs)
    # the doomed replica's in-flight slots were checkpointed and migrated
    assert out["drains"] == 1
    assert out["migrated_slots"] > 0
    victim = cl.replica_by_rid(0)
    assert victim.state == ReplicaState.TERMINATED
    # greedy decode is placement-independent: every drained request's
    # continuation must be IDENTICAL to the uninterrupted run (no token
    # recomputed or lost through the checkpoint/restore migration)
    for a, b in zip(base_reqs, reqs):
        assert a.out_tokens == b.out_tokens, a.rid
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    # a replacement was pre-warmed at the rebalance recommendation
    assert any(r.ready_at > 0 for r in cl.replicas)


def test_drain_requeues_waiting_requests(model):
    """Queued (not yet admitted) work on the doomed replica is re-routed."""
    cfg, params = model
    cl = ServingCluster(cfg, params, HETERO_FLEET[:2],
                        router=RoundRobinRouter(), dt=1.0,
                        batch_size=2, max_seq=32,
                        rebalance_lead=2.0, notice_deadline=2.0, device="cpu")
    for r in make_requests(12, seed=1):
        cl.submit(r, at=0.0)
    cl.inject_interruption(t=1.0, replica_rid=0)
    out = cl.run(max_time=5000)
    assert out["dropped"] == 0 and out["completed"] == 12


# ----------------------------------------------------------------- scaling
def test_autoscaler_scales_up_under_backlog(model):
    cfg, params = model
    cl = ServingCluster(
        cfg, params, [InstanceType("base", 1.0)],
        router=RateAwareRouter(), dt=1.0, batch_size=2, max_seq=32,
        autoscaler_kw=dict(scale_up_backlog=16.0, scale_up_patience=2.0,
                           replacement_latency=3.0, max_replicas=3),
        device="cpu")
    for r in make_requests(24, seed=2):
        cl.submit(r, at=0.0)
    out = cl.run(max_time=5000)
    assert len(cl.replicas) > 1          # fleet grew
    assert out["dropped"] == 0 and out["completed"] == 24


# ----------------------------------------------------------------- pieces
def test_spot_feed_lifecycle_ordering():
    feed = SpotEventFeed(rebalance_lead=10.0, notice_deadline=5.0)
    feed.inject_interruption(t=100.0, target=7)
    assert feed.poll(99.9) == []
    (rec,) = feed.poll(100.0)
    assert rec.kind == "rebalance_recommendation" and rec.target == 7
    (notice,) = feed.poll(110.0)
    assert notice.kind == "interruption_notice"
    (term,) = feed.poll(1e9)
    assert term.kind == "terminate"
    assert feed.next_event_t == float("inf")


def test_greedy_refine_base_load():
    """Pinned in-flight load steers placement away from busy PEs."""
    res = lb.greedy([4.0, 4.0], 2, rates=[1.0, 1.0], base=[100.0, 0.0])
    assert (res.assignment == 1).all()
    res = lb.greedy_refine([4.0] * 6, 2, rates=[1.0, 1.0],
                           current=[0] * 6, base=[50.0, 0.0])
    # overloaded PE 0 donates work to the empty PE 1
    assert (res.assignment == 1).sum() > 0
    assert res.makespan <= res.baseline_makespan


def test_engine_snapshot_restore_exact(model):
    """Slot migration across engines resumes the exact continuation."""
    cfg, params = model
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 200, 5, dtype=np.int32)
    e0 = ServingEngine(cfg, params, batch_size=2, max_seq=32, device="cpu")
    r0 = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
    e0.submit(r0)
    e0.run_until_idle()
    e1 = ServingEngine(cfg, params, batch_size=2, max_seq=32, device="cpu")
    r1 = Request(rid=1, prompt=prompt.copy(), max_new_tokens=8)
    e1.submit(r1)
    for _ in range(4):          # prompt bulk-prefilled on admit, then decode
        e1.step()
    units, queued = e1.drain_units()
    assert len(units) == 1 and not queued
    assert 0 < len(r1.out_tokens) < r1.max_new_tokens
    e2 = ServingEngine(cfg, params, batch_size=2, max_seq=32, device="cpu")
    e2.unpack(units)
    e2.run_until_idle()
    assert r1.done and r1.out_tokens == r0.out_tokens


# ------------------------------------- replicas (test_migration.py)
ARCHS = ["granite-8b", "mamba2-780m"]     # causal + ssm families


@pytest.fixture(scope="module")
def models(model):
    cfg = get_config("mamba2-780m").reduced()
    return {"granite-8b": model,
            "mamba2-780m": (cfg, zoo.init_serving_params(cfg, seed=0,
                                                         device="cpu"))}


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n, dtype=np.int32)


def _replica(cfg, params, rid, speed=1.0, accelerator=False):
    return Replica(rid, cfg, params,
                   InstanceType(f"r{rid}", speed, accelerator=accelerator),
                   batch_size=2, max_seq=64, device="cpu")


def _reference_tokens(cfg, params, prompt, max_new):
    eng = ServingEngine(cfg, params, batch_size=2, max_seq=64, device="cpu")
    req = Request(rid=99, prompt=prompt.copy(), max_new_tokens=max_new)
    eng.submit(req)
    eng.run_until_idle()
    assert req.done
    return req.out_tokens


def _finish(rep):
    while rep.has_work():
        rep.step_once(now=0.0)
    rep.engine.pop_completed()


@pytest.mark.parametrize("arch", ARCHS)
def test_replica_migrate_mid_decode_bit_identical(models, arch):
    """pack_slots mid-generation -> unpack on another replica."""
    cfg, params = models[arch]
    prompt = _prompt(cfg, 12, seed=1)
    ref = _reference_tokens(cfg, params, prompt, max_new=12)

    src = _replica(cfg, params, 0)
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=12)
    src.submit(req)
    while src.engine.fed_tokens(0) <= len(prompt):   # cross into decode
        src.step_once(now=0.0)
    assert len(prompt) < src.engine.fed_tokens(0) < len(prompt) + 11
    occupied = [s for s, _ in src.engine.slot_costs()]
    units, (ckpt_s, restore_s) = src.pack_slots(occupied[:1])
    assert len(units) == 1
    assert units[0].residency == "host"     # staged through the endpoint
    assert 0 < len(req.out_tokens) < 12     # pack poll materialized
    assert ckpt_s >= 0.0 and restore_s >= 0.0   # store stages exercised
    assert src.engine.n_active == 0     # slot released on the source

    dst = _replica(cfg, params, 1)
    dst.unpack(units)
    _finish(dst)
    assert req.done
    assert req.out_tokens == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_replica_migrate_mid_prefill_chunk_bit_identical(models, arch):
    """Snapshot right after the bulk prefill chunk, before the prompt is
    fully fed, and restore on a different replica."""
    cfg, params = models[arch]
    prompt = _prompt(cfg, 30, seed=2)
    ref = _reference_tokens(cfg, params, prompt, max_new=8)

    eng = ServingEngine(cfg, params, batch_size=2, max_seq=64,
                        prefill_buckets=(16,), device="cpu")
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
    eng.submit(req)
    eng.step()                          # admit: one 16-token chunk + 1 step
    assert eng.chunk_prefills == 1
    assert eng.fed_tokens(0) < len(prompt) - 1   # still mid-prefill
    units = eng.pack()
    assert len(units) == 1 and units[0].progress < len(prompt)
    assert req.out_tokens == []

    dst = _replica(cfg, params, 1)
    dst.unpack(units)
    _finish(dst)
    assert req.done
    assert req.out_tokens == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_replica_double_migration_bit_identical(models, arch):
    """Two hops (src -> mid -> dst), one mid-prefill and one mid-decode,
    still reproduce the reference stream exactly."""
    cfg, params = models[arch]
    prompt = _prompt(cfg, 24, seed=3)
    ref = _reference_tokens(cfg, params, prompt, max_new=10)

    src = _replica(cfg, params, 0)
    src.engine._buckets = tuple(b for b in src.engine._buckets
                                if b <= 16)     # force a streamed tail
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=10)
    src.submit(req)
    src.step_once(now=0.0)              # hop 1: mid-prefill
    units, _ = src.pack_slots([s for s, _ in src.engine.slot_costs()])
    mid = _replica(cfg, params, 1)
    mid.unpack(units)
    while mid.engine.fed_tokens(0) <= len(prompt):  # cross into decode
        mid.step_once(now=0.0)
    assert mid.engine.fed_tokens(0) > len(prompt)   # hop 2: mid-decode
    units, _ = mid.pack_slots([s for s, _ in mid.engine.slot_costs()])
    assert all(u.residency == "host" for u in units)
    assert 0 < len(req.out_tokens) < 10
    dst = _replica(cfg, params, 2)
    dst.unpack(units)
    _finish(dst)
    assert req.done
    assert req.out_tokens == ref


def test_replica_selective_snapshot_leaves_other_slots_running(models):
    """pack_slots([victim]) must not disturb the co-resident slot:
    it keeps decoding on the source to its reference continuation."""
    cfg, params = models["granite-8b"]
    p0, p1 = _prompt(cfg, 6, seed=4), _prompt(cfg, 6, seed=5)
    ref0 = _reference_tokens(cfg, params, p0, max_new=10)
    ref1 = _reference_tokens(cfg, params, p1, max_new=10)

    src = _replica(cfg, params, 0)
    r0 = Request(rid=0, prompt=p0.copy(), max_new_tokens=10)
    r1 = Request(rid=1, prompt=p1.copy(), max_new_tokens=10)
    src.submit(r0)
    src.submit(r1)
    for _ in range(2):
        src.step_once(now=0.0)
    assert src.engine.n_active == 2
    victim = [s for s, _ in src.engine.slot_costs()
              if src.engine._slots[s].rid == 0]
    units, _ = src.pack_slots(victim)
    assert [u.rid for u in units] == [0]
    assert src.engine.n_active == 1     # r1 still in place

    dst = _replica(cfg, params, 1)
    dst.unpack(units)
    _finish(dst)
    _finish(src)
    assert r0.done and r0.out_tokens == ref0
    assert r1.done and r1.out_tokens == ref1


# ------------------------------- replicas and clusters (test_workunit.py)
def test_deprecated_verbs_removed(model):
    """The PUP verbs are the only spelling on the replica."""
    cfg, params = model
    rep = _replica(cfg, params, 0)
    for old in ("checkpoint_slots", "restore", "drain"):
        assert not hasattr(rep, old), old


def test_accelerator_replica_stages_device_resident(model):
    """An accelerator InstanceType drains through the DeviceStore
    endpoint (HBM-to-HBM analogue) and the stream stays exact."""
    cfg, params = model
    prompt = _prompt(cfg, 8, seed=6)
    ref = _reference_tokens(cfg, params, prompt, max_new=10)

    src = _replica(cfg, params, 0, accelerator=True)
    assert isinstance(src.endpoint, DeviceEndpoint)
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=10)
    src.submit(req)
    for _ in range(2):
        src.step_once(now=0.0)
    units, queued, (ckpt_s, restore_s) = src.drain_units()
    assert len(units) == 1 and not queued
    assert units[0].residency == "device"
    assert ckpt_s > 0.0 and restore_s > 0.0     # stages really ran

    dst = _replica(cfg, params, 1)
    assert isinstance(dst.endpoint, HostEndpoint)
    dst.unpack(units)
    _finish(dst)
    assert req.done and req.out_tokens == ref


def _mini_cluster(cfg, params, *, preempt, n_rep=1):
    fleet = [InstanceType("std.1x", 1.0, cost_per_hour=2.0)
             for _ in range(n_rep)]
    return ServingCluster(
        cfg, params, fleet, batch_size=2, max_seq=48, dt=1.0,
        decode_block=2,
        preemption=SLOPreemption() if preempt else None,
        autoscaler_kw=dict(scale_up_backlog=1e9, slo_scale_up=False),
        device="cpu")


def test_slo_preemption_frees_batch_for_interactive(model):
    """A batch-saturated replica pauses batch slots for an interactive
    surge; everything completes, streams match the no-preemption run."""
    cfg, params = model
    interactive = SLOClass("interactive", 0, deadline=16.0)
    batch = SLOClass("batch", 2, deadline=2000.0, admit_lazily=True)

    def reqs():
        rng = np.random.default_rng(11)
        out = [(0.0, Request(rid=i,
                             prompt=rng.integers(0, cfg.vocab_size, 6,
                                                 dtype=np.int32),
                             max_new_tokens=30, slo=batch))
               for i in range(2)]
        out += [(6.0, Request(rid=2 + i,
                              prompt=rng.integers(0, cfg.vocab_size, 4,
                                                  dtype=np.int32),
                              max_new_tokens=5, slo=interactive))
                for i in range(2)]
        return out

    outs = {}
    for preempt in (False, True):
        cl = _mini_cluster(cfg, params, preempt=preempt)
        rs = reqs()
        for at, r in rs:
            cl.submit(r, at=at)
        out = cl.run(max_time=5000)
        outs[preempt] = (rs, out)
        assert out["completed"] == 4 and out["dropped"] == 0

    (rs0, off), (rs1, on) = outs[False], outs[True]
    assert on["preemptions"] > 0
    assert on["resumes"] == on["preemptions"]    # nothing stays parked
    assert off["preemptions"] == 0
    # preemption strictly improves interactive latency, tokens unchanged
    assert (on["p99_latency_interactive"]
            < off["p99_latency_interactive"])
    for (_, a), (_, b) in zip(rs0, rs1):
        assert a.out_tokens == b.out_tokens, a.rid


def test_preemption_counts_in_traces(model):
    """The preempted batch request's trace records the pause."""
    cfg, params = model
    interactive = SLOClass("interactive", 0, deadline=16.0)
    batch = SLOClass("batch", 2, deadline=2000.0, admit_lazily=True)
    cl = _mini_cluster(cfg, params, preempt=True)
    rng = np.random.default_rng(12)
    for i in range(2):
        cl.submit(Request(rid=i,
                          prompt=rng.integers(0, cfg.vocab_size, 6,
                                              dtype=np.int32),
                          max_new_tokens=30, slo=batch), at=0.0)
    cl.submit(Request(rid=2,
                      prompt=rng.integers(0, cfg.vocab_size, 4,
                                          dtype=np.int32),
                      max_new_tokens=5, slo=interactive), at=6.0)
    out = cl.run(max_time=5000)
    assert out["completed"] == 3
    assert out["preemptions"] >= 1
    assert sum(tr.preemptions for tr in cl.metrics.traces.values()) \
        == out["preemptions"]
    assert all(tr.slo == "batch" for tr in cl.metrics.traces.values()
               if tr.preemptions)


def test_cost_aware_scaling_shops_by_price_performance(model):
    """The catalog's best speed-per-dollar type wins scale-ups AND spot
    replacements; pool-incompatible entries are ignored."""
    cfg, params = model
    big = InstanceType("big.2x", 2.0, cost_per_hour=4.0)      # 0.5 /$
    lean = InstanceType("lean.1x", 1.0, cost_per_hour=0.8)    # 1.25/$
    other = InstanceType("other", 9.0, cost_per_hour=0.1,
                         model_id="other-pool")
    policy = CostAwareScaling([big, lean, other])
    cl = ServingCluster(cfg, params, [big], batch_size=2, max_seq=48,
                        scaling=policy, device="cpu")
    rep = cl.replicas[0]
    assert policy.select_itype(cl.view, "default", [rep]) is lean
    assert policy.replacement(cl.view, rep) is lean
    assert any("cost-aware pick lean.1x" in m for _, m in cl.timeline)
    with pytest.raises(ValueError):
        CostAwareScaling([])


def test_default_itype_pool_validated_at_construction(model):
    """A default_itype serving NO pool is rejected up front; a default
    serving a DIFFERENT pool is substituted with a logged fallback."""
    cfg, params = model
    fleet = [InstanceType("std.1x", 1.0)]
    with pytest.raises(ValueError, match="no fleet instance"):
        ServingCluster(cfg, params, fleet, batch_size=2, max_seq=48,
                       autoscaler_kw=dict(default_itype=InstanceType(
                           "ghost", 1.0, model_id="missing-pool")),
                       device="cpu")
    fleet2 = [InstanceType("std.1x", 1.0),
              InstanceType("b.1x", 1.0, model_id="b")]
    cl = ServingCluster(cfg, params, fleet2, batch_size=2, max_seq=48,
                        models={"b": (cfg, params)},
                        autoscaler_kw=dict(default_itype=fleet2[1]),
                        device="cpu")
    policy = cl.autoscaler.policy
    picked = policy.select_itype(cl.view, "default", [cl.replicas[0]])
    assert picked is cl.replicas[0].itype
    assert any("using std.1x instead" in m for _, m in cl.timeline)


def test_replica_dollar_metering():
    """Per-pool dollar cost integrates launch->terminate (or horizon)."""
    m = ClusterMetrics()
    m.on_launch(0, "a", model_id="default", cost_per_hour=3600.0, t=0.0)
    m.on_launch(1, "b", model_id="other", cost_per_hour=1800.0, t=100.0)
    m.on_terminate(0, 50.0)
    pools = m.pool_dollar_cost(horizon=200.0)
    assert pools["default"] == pytest.approx(50.0)    # retired at 50
    assert pools["other"] == pytest.approx(50.0)      # alive 100->200
    assert m.fleet_dollar_cost(200.0) == pytest.approx(100.0)
    m.on_launch(2, "c", model_id="late", cost_per_hour=3600.0, t=500.0)
    assert m.pool_dollar_cost(200.0)["late"] == 0.0


# ------------------------------------------------ endpoints and devices
def _bits(t):
    assert isinstance(t, torch.Tensor)
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("kind", ["device", "host"])
def test_endpoint_roundtrips_bf16_columns_bitwise(model, kind):
    """Both endpoints give a bf16 unit's columns back as CPU tensors,
    bit for bit, and stamp the residency; ``put``/``fetch`` too."""
    cfg, params = model
    eng = ServingEngine(cfg, params, batch_size=2, max_seq=32,
                        cache_mode="paged", block_size=8, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32),
                       max_new_tokens=6))
    eng.step_many(2)
    units = eng.pack()
    want = {k: _bits(v).copy() for k, v in units[0].snapshot.cache.items()}
    assert any(v.dtype == torch.bfloat16
               for v in units[0].snapshot.cache.values())
    ep = make_endpoint(kind, device="cpu")
    ckpt_s, restore_s = ep.roundtrip(units, "migrate")
    got = units[0].snapshot.cache
    assert units[0].residency == kind and ckpt_s > 0 and restore_s > 0
    assert all(v.device.type == "cpu" for v in got.values())
    assert {k: _bits(v).tobytes() for k, v in got.items()} == \
        {k: v.tobytes() for k, v in want.items()}
    assert ep.put(units, "ckpt") > 0
    units[0].snapshot.cache = {}
    ep.fetch(units, "ckpt")
    assert {k: _bits(v).tobytes()
            for k, v in units[0].snapshot.cache.items()} == \
        {k: v.tobytes() for k, v in want.items()}


def test_entry_points_default_to_the_card(model):
    """``ServingCluster``, ``Replica`` and the endpoints default to
    ``device="cuda"`` and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg, params = model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingCluster(cfg, None, [InstanceType("a", 1.0)], engine="sim")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Replica(0, cfg, None, InstanceType("a", 1.0), engine_cls=SimEngine)
    for kind in ("host", "device"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_endpoint(kind)


# ------------------------------------------------- parity with repro
from tests._torch_parity import JAX, TORCH, f32_models  # noqa: E402
from tests._torch_parity import record as _record  # noqa: E402


def _sim_run(p):
    """SimEngine fleet: Poisson arrivals, two spot interruptions and a
    recurring rebalance pass."""
    C = p.cluster
    trace = p.runtime.FaultTrace(rebalance_lead=6.0, notice_deadline=4.0)
    trace.inject(4.0, 0)
    trace.inject(14.0, 2)
    cl = C.ServingCluster(
        None, None, p.serve._parse_fleet("2x2.0,2x0.7"), engine="sim",
        router=C.RateAwareRouter(), batch_size=4, max_seq=256, dt=1.0,
        trace=trace, rebalance_interval=2.0, **p.dev)
    reqs = p.workload.synthetic_requests(48, 1000, seed=5,
                                         prompt_len=(3, 64),
                                         max_new=(4, 40))
    cl.attach_arrivals(p.workload.PoissonArrivals(reqs, 3.0, seed=2))
    return _record(cl, reqs, cl.run())


def test_sim_cluster_matches_reference():
    ref, got = _sim_run(JAX), _sim_run(TORCH)
    assert got["summary"]["drains"] == 2
    assert got["summary"]["rebalance_migrations"] > 0
    assert got["summary"]["completed"] == 48
    assert got == ref


@pytest.fixture(scope="module")
def f32():
    """Reduced float32 granite-8b with the JAX weights in both packages."""
    return f32_models()


def _cli_args(**kw):
    """The launcher's defaults for ``_make_requests``."""
    import types
    base = dict(requests=16, seed=0, max_seq=48, max_new=24, slo_mix=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _engine_run(p, model, *, paged=False, chaos=False):
    """``serve --cluster --fleet 2x2.0,2x0.7 --router rate_aware
    --interrupt-at 4`` at batch 2, max_seq 48, through each package's
    own launcher helpers; ``chaos`` adds a seeded fault soup, a hard
    kill, checkpoints and the failure detector."""
    cfg, params = model
    C = p.cluster
    engine = None
    if paged:
        engine = functools.partial(p.engine.ServingEngine,
                                   cache_mode="paged", block_size=8)
    kw = {}
    if chaos:
        trace = p.runtime.FaultTrace.chaos_sampled(
            rate=0.25, horizon=30.0, targets=4, seed=7, rebalance_lead=6.0,
            notice_deadline=4.0)
        trace.inject_hard_kill(5.0, 1)
        kw = dict(trace=trace,
                  checkpoint=C.CheckpointPolicy(interval=2.0),
                  health=C.FailureDetector(heartbeat_interval=1.0,
                                           check_interval=1.0,
                                           suspect_after=2.5,
                                           confirm_after=5.0),
                  straggler=C.StragglerPolicy())
    cl = C.ServingCluster(cfg, params, p.serve._parse_fleet("2x2.0,2x0.7"),
                          router=C.ROUTERS["rate_aware"](), batch_size=2,
                          max_seq=48, decode_block=8, dt=1.0, seed=0,
                          rebalance_lead=6.0, notice_deadline=4.0,
                          engine=engine, **kw, **p.dev)
    reqs = p.serve._make_requests(_cli_args(), cfg)
    cl.attach_arrivals(p.workload.make_arrivals("batch", reqs, seed=0))
    cl.inject_interruption(t=4.0, replica_rid=0)
    return _record(cl, reqs, cl.run())


@pytest.fixture(scope="module")
def dense_runs(f32):
    return {name: _engine_run(p, f32[name])
            for name, p in (("jax", JAX), ("torch", TORCH))}


def test_dense_cluster_matches_reference_f32(dense_runs):
    ref, got = dense_runs["jax"], dense_runs["torch"]
    assert got["summary"]["drains"] == 1
    assert got["summary"]["migrated_slots"] > 0
    assert got["summary"]["completed"] == 16
    assert all(len(s) == 24 for s in got["streams"])
    assert got == ref


def test_paged_cluster_matches_reference_f32(f32, dense_runs):
    """Paged replicas through the ``engine=`` seam in both packages: the
    same digest and summary as each other, and the dense run's streams."""
    ref = _engine_run(JAX, f32["jax"], paged=True)
    got = _engine_run(TORCH, f32["torch"], paged=True)
    assert got["summary"]["peak_block_occupancy"] > 0
    assert got == ref
    assert got["streams"] == dense_runs["torch"]["streams"]


def test_chaos_cluster_matches_reference_f32(f32, dense_runs):
    """The seeded soup plus a hard kill, survived through checkpoints and
    the failure detector: the same digest and summary in both packages,
    every request served with the fault-free streams."""
    ref = _engine_run(JAX, f32["jax"], chaos=True)
    got = _engine_run(TORCH, f32["torch"], chaos=True)
    s = got["summary"]
    assert s["hard_kills"] >= 1 and s["checkpoints"] >= 1
    assert s["requests_recovered"] >= 1 and s["completed"] == 16
    assert got == ref
    assert got["streams"] == dense_runs["torch"]["streams"]
