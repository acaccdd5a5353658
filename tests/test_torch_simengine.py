"""The port's ``SimEngine`` against the reference's, and against the
port's own ``ServingEngine``.

The ``SimEngine`` cases of ``test_vertical.py`` (resize mirrors the real
engine, resize interleavings conserve units, the QoS shrink order at the
engine level) on ``repro_torch.serving.simengine``, with fixed seeds
where the reference draws from hypothesis; then one seeded script of
every verb run in both packages gives the same streams, step statistics,
costs and counters; and the port's ``SimEngine`` accounts a window as the
port's real engine does.
"""

import numpy as np
import pytest
import torch

from repro.serving import simengine as jsim
from repro.serving.engine import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.simengine import SimEngine, sim_token
from repro_torch.serving.workload import (BATCH, INTERACTIVE, STANDARD,
                                          SLOClass)
from repro_torch.serving.workunit import PAUSED, WorkUnit
from repro_torch.vertical import QoSPolicy

torch.set_num_threads(1)


def _requests(n, seed=3, max_new=6, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(0, 200, int(rng.integers(3, 20)))
                .astype(np.int32),
                max_new_tokens=max_new)
            for i in range(n)]


def _assert_sim_streams(reqs):
    for r in reqs:
        assert r.done
        assert list(r.out_tokens) == [sim_token(r.rid, i)
                                      for i in range(len(r.out_tokens))]


def test_sim_token_matches_reference():
    for rid, i in ((0, 0), (7, 3), (123456, 789), (5, 49_999)):
        assert sim_token(rid, i) == jsim.sim_token(rid, i)


def test_sim_engine_resize_mirrors_real():
    """SimEngine speaks the same resize verb: grow admits the queue,
    shrink evicts PAUSED units, resumed streams stay the deterministic
    ``sim_token`` sequence."""
    reqs = _requests(5)
    eng = SimEngine(batch_size=4, max_seq=64)
    for r in reqs:
        eng.submit(r)
    for _ in range(2):
        eng.step()
    evicted = eng.resize(batch_size=1)
    assert evicted and all(u.state is PAUSED for u in evicted)
    assert all(isinstance(u, WorkUnit) for u in evicted)
    assert eng.resizes == 1 and eng.resize_evictions == len(evicted)
    eng.resume(evicted)
    eng.resize(batch_size=3)
    eng.run_until_idle()
    _assert_sim_streams(reqs)


def _interleave(seed: int):
    """The reference's random resize/preempt/resume/step interleaving:
    every submitted request finishes with its deterministic stream."""
    rng = np.random.default_rng(seed)
    eng = SimEngine(batch_size=3, max_seq=64)
    reqs = _requests(6, seed=seed, max_new=5)
    for r in reqs:
        eng.submit(r)
    paused = []
    for _ in range(rng.integers(8, 16)):
        op = rng.integers(0, 4)
        if op == 0:
            eng.step()
        elif op == 1:
            paused.extend(eng.resize(batch_size=int(rng.integers(1, 5))))
        elif op == 2:
            paused.extend(eng.preempt())
        elif op == 3 and paused:
            batch, paused = paused, []
            eng.resume(batch)
    eng.resume(paused)
    eng.run_until_idle()
    _assert_sim_streams(reqs)


@pytest.mark.parametrize("seed", range(6))
def test_resize_interleaving_conserves_units_sim(seed):
    _interleave(seed)


def test_resize_interleaving_fixed_seeds():
    """The reference's hypothesis property (25 draws of a seed in
    [0, 10000]) as 25 fixed seeds."""
    for seed in np.random.default_rng(2024).integers(0, 10_001, 25):
        _interleave(int(seed))


def test_qos_shrink_evicts_best_effort_first():
    """A QoS-keyed shrink takes batch work before interactive even when
    the interactive stream has made less progress."""
    eng = SimEngine(batch_size=4, max_seq=64)
    slos = [BATCH, INTERACTIVE, BATCH, STANDARD]
    reqs = [Request(rid=i, prompt=np.arange(3, dtype=np.int32) + 1,
                    max_new_tokens=8, slo=s)
            for i, s in enumerate(slos)]
    for r in reqs[1:]:
        eng.submit(r)
    eng.step()
    eng.submit(reqs[0])
    eng.step()
    evicted = eng.resize(batch_size=2, evict_key=QoSPolicy.evict_key)
    assert [u.slo_name for u in evicted] == ["batch", "batch"]
    survivors = {r.slo.name for _, r in eng.slot_requests()}
    assert survivors == {"interactive", "standard"}


def _script(engine_cls, request_cls, slo_cls, seed):
    """One seeded run through every verb; returns what it observed."""
    rng = np.random.default_rng(seed)
    eng = engine_cls(batch_size=3, max_seq=64, decode_block=3)
    other = engine_cls(batch_size=2, max_seq=64)
    lazy = slo_cls("batch", 2, deadline=50.0, admit_lazily=True)
    reqs = []
    for i in range(10):
        reqs.append(request_cls(
            rid=i, prompt=rng.integers(0, 200, int(rng.integers(2, 30)))
            .astype(np.int32), max_new_tokens=int(rng.integers(1, 9)),
            slo=lazy if i % 3 == 0 else None))
    seen = []
    parked = []
    for i, r in enumerate(reqs):
        eng.submit(r)
        op = int(rng.integers(0, 7))
        if op == 0:
            seen.append(("stats", eng.step_many(int(rng.integers(1, 5)))))
        elif op == 1:
            parked.extend(eng.preempt())
        elif op == 2 and parked:
            eng.resume(parked)
            parked = []
        elif op == 3:
            other.unpack(eng.pack())
            seen.append(("other", other.step_many(2)))
        elif op == 4:
            parked.extend(eng.resize(batch_size=int(rng.integers(1, 5))))
        elif op == 5:
            seen.append(("ckpt", [(u.rid, u.snapshot.fed,
                                   u.snapshot.next_tok,
                                   list(u.snapshot.request.out_tokens))
                                  for u in eng.checkpoint_units()]))
        else:
            units, queued = other.drain_units()
            eng.unpack(units)
            for q in queued:
                eng.submit(q)
        seen.append(("costs", eng.backlog_tokens(), eng.slot_costs(),
                     eng.restore_costs(), eng.n_queued, eng.free_slots))
    eng.resume(parked)
    units, queued = other.drain_units()
    eng.unpack(units)
    for q in queued:
        eng.submit(q)
    seen.append(("idle", eng.run_until_idle()))
    counters = {k: getattr(eng, k) for k in (
        "processed_tokens", "host_syncs", "chunk_prefills", "preemptions",
        "resumes", "resizes", "resize_evictions", "_peak_slots", "batch")}
    return [list(r.out_tokens) for r in reqs], seen, counters


@pytest.mark.parametrize("seed", range(4))
def test_same_seeded_run_as_reference(seed):
    from repro.serving.workload import SLOClass as JSLOClass
    ours = _script(SimEngine, Request, SLOClass, seed)
    ref = _script(jsim.SimEngine, JRequest, JSLOClass, seed)
    assert ours[0] == ref[0]
    assert ours[1] == ref[1]
    assert ours[2] == ref[2]
    assert all(tokens for tokens in ours[0])


def test_window_accounting_matches_real_engine():
    """The SimEngine's step statistics are the port's real engine's for
    prompts that one bulk-prefill chunk covers (its common case)."""
    cfg = get_config("granite-8b").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    real = ServingEngine(cfg, params, batch_size=3, max_seq=64,
                         prefill_buckets=(16, 64), device="cpu")
    sim = SimEngine(batch_size=3, max_seq=64)
    for eng in (real, sim):
        for r in _requests(5, seed=8, max_new=7):
            eng.submit(r)
    for n in (1, 4, 2, 8, 3, 8):
        assert real.step_many(n) == sim.step_many(n)
        assert real.slot_costs() == sim.slot_costs()
        assert real.backlog_tokens() == pytest.approx(sim.backlog_tokens())
    assert real.processed_tokens == sim.processed_tokens
    assert real.chunk_prefills == sim.chunk_prefills
