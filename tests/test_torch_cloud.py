"""The CloudManager on the port, and against the reference.

A mirror of ``test_cloud.py`` (the trigger conditions and the mode
comparisons) and of ``test_system.py``'s C4/C5 claim on
``repro_torch.core.cloud``.  Then parity: for modes A, B and C over
seeds 0-2, a seeded interruption schedule plus an injected batch gives
the reference's ``RunReport`` and the same journal digest of the
manager's ``EventLoop``.
"""

import dataclasses

import pytest

import repro.core.cloud as jcloud
import repro.runtime as jruntime
import repro_torch.core.cloud as tcloud
import repro_torch.runtime as truntime
from repro_torch.core.cloud import CloudManager, Mode, StageCostModel


def make_cm(mode, *, n=16, count=4, t=100.0, **kw):
    cm = CloudManager(n_instances=n, mode=mode,
                      cost=StageCostModel(state_bytes=n * 64e6),
                      total_iters=2000, iter_seconds=0.2, **kw)
    cm.inject_interruption(t=t, count=count)
    return cm


def _events(rep, key):
    return [e for t, e in rep.timeline if key in e]


def test_mode_c_single_rescale():
    cm = make_cm(Mode.C_PROACTIVE, count=4)
    rep = cm.run()
    assert len(rep.rescales) == 1
    assert rep.rescales[0]["reason"].startswith("proactive")


def test_mode_b_two_rescales_per_interruption_batch():
    cm = make_cm(Mode.B_REACTIVE, count=4)
    rep = cm.run()
    kinds = [r["reason"] for r in rep.rescales]
    assert kinds.count("shrink") == 4 and kinds.count("expand") == 4


def test_mode_ordering_c_best():
    overheads = {}
    for mode in Mode:
        rep = make_cm(mode, count=8).run()
        overheads[mode] = rep.overhead_frac
    assert overheads[Mode.C_PROACTIVE] < overheads[Mode.B_REACTIVE]
    assert overheads[Mode.C_PROACTIVE] < overheads[Mode.A_FILESYSTEM]
    # paper: <1% on a 5000-iter run; this shorter run (2000 iters) scales
    # the same absolute overhead to a larger fraction
    assert overheads[Mode.C_PROACTIVE] < 0.03


def test_complete_replacement_trigger():
    """Replacements ready before notices -> 'complete' trigger fires."""
    cm = make_cm(Mode.C_PROACTIVE, count=2,
                 replacement_latency=60.0, rebalance_lead=300.0)
    rep = cm.run()
    assert any("proactive_complete" == r["reason"] for r in rep.rescales)


def test_emergency_override_trigger():
    """Notice arrives before replacements -> emergency partial replacement."""
    cm = make_cm(Mode.C_PROACTIVE, count=2,
                 replacement_latency=500.0, rebalance_lead=30.0,
                 t_timeout=1000.0)
    rep = cm.run()
    assert any("proactive_emergency" == r["reason"] for r in rep.rescales)


def test_timeout_trigger():
    """No notice, slow replacements -> T_timeout forces the rescale."""
    cm = make_cm(Mode.C_PROACTIVE, count=2,
                 replacement_latency=80.0, rebalance_lead=10_000.0,
                 t_timeout=120.0)
    rep = cm.run()
    reasons = [r["reason"] for r in rep.rescales]
    assert "proactive_timeout" in reasons or "proactive_complete" in reasons
    # the rescale must happen within ~T_timeout of the recommendation
    t_rescale = rep.rescales[0]["t"]
    assert t_rescale <= 100.0 + 120.0 + 1e-6


def test_mode_a_downtime_and_rollback():
    cm = make_cm(Mode.A_FILESYSTEM, count=1)
    rep = cm.run()
    assert _events(rep, "job_down")
    assert _events(rep, "fs_restart")
    # overhead includes the down window -> strictly positive
    assert rep.overhead_frac > 0.01


def test_overhead_scales_with_interruptions_mode_b_not_c():
    b1 = make_cm(Mode.B_REACTIVE, count=1).run().overhead_frac
    b8 = make_cm(Mode.B_REACTIVE, count=8).run().overhead_frac
    c1 = make_cm(Mode.C_PROACTIVE, count=1).run().overhead_frac
    c8 = make_cm(Mode.C_PROACTIVE, count=8).run().overhead_frac
    assert b8 > 3 * b1          # reactive cost grows with interruptions
    assert c8 < 1.5 * c1 + 1e-3  # proactive stays flat (paper Fig 8)


def test_rebalancing_halves_overhead_vs_reactive():
    """Paper: capacity rebalancing cuts interruption-handling overhead ~50%."""
    b = make_cm(Mode.B_REACTIVE, count=1).run()
    c = make_cm(Mode.C_PROACTIVE, count=1).run()
    assert c.interruption_overhead < 0.6 * b.interruption_overhead


def test_c4_c5_mode_comparison():
    """Fig 7/8: C < B, and C < A; C end-to-end overhead < 1%."""
    ov = {}
    for mode in Mode:
        cm = CloudManager(n_instances=16, mode=mode,
                          cost=StageCostModel(state_bytes=16 * 64e6),
                          total_iters=5000, iter_seconds=0.2)
        cm.inject_interruption(t=100.0, count=8)
        ov[mode] = cm.run().overhead_frac
    assert ov[Mode.C_PROACTIVE] < 0.01
    assert ov[Mode.C_PROACTIVE] < 0.5 * ov[Mode.B_REACTIVE]
    assert ov[Mode.B_REACTIVE] < ov[Mode.A_FILESYSTEM] * 2.5


# ------------------------------------------------- parity with repro
def _cloud_run(cloud, runtime, mode, seed):
    """A 16-instance fleet on a seeded interruption schedule (Poisson
    over 600 s, shared through ``trace=``) plus 4 injected at t = 100."""
    trace = runtime.FaultTrace.sampled(rate=0.01, horizon=600.0,
                                       targets=16, seed=seed,
                                       rebalance_lead=180.0,
                                       notice_deadline=120.0)
    cm = cloud.CloudManager(
        n_instances=16, mode=cloud.Mode(mode),
        cost=cloud.StageCostModel(state_bytes=16 * 64e6),
        total_iters=3000, iter_seconds=0.2, seed=seed, trace=trace)
    cm.inject_interruption(t=100.0, count=4)
    rep = cm.run()
    return dict(report=dataclasses.asdict(rep),
                overhead_frac=rep.overhead_frac,
                digest=cm.loop.journal_digest, events=cm.loop.dispatched,
                fleet=[dataclasses.asdict(i) for i in cm.fleet.values()])


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", ["A", "B", "C"])
def test_cloud_manager_matches_reference(mode, seed):
    ref = _cloud_run(jcloud, jruntime, mode, seed)
    got = _cloud_run(tcloud, truntime, mode, seed)
    assert got["report"]["rescales"] and got["events"] > 10
    assert got == ref
