"""Work-unit migration in the port, and units crossing packages.

The engine-level cases of ``test_workunit.py``, ``test_migration.py``,
``test_paged.py`` and ``test_vertical.py`` run on the port's
``ServingEngine`` (reduced configs, the port's own seeded weights): a
slot packed, preempted, resized or checkpointed at any point of its
request's life resumes to the stream of a run that was never moved, bit
for bit.  Then units cross packages in both directions, with the JAX
weights carried over by ``params_from_numpy``: the float32 greedy
granite-8b stream continues token for token like an unmigrated JAX run,
and every cache column (bf16 ones too, for mamba2 and zamba2, which the
reference serves in bf16 only) crosses bit for bit.

The reference's ``test_any_interleaving_roundtrips_identically`` fails
in the reference (ROADMAP §3): ``pack`` takes only occupied slots, so an
op list that packs before any step leaves the request queued in the old
engine.  The port pins that behaviour instead, with fixed cases: ``pack``
leaves queued and restore-queued work behind, and ``drain_units`` takes
it.
"""

import dataclasses
import functools

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jtransformer
from repro.models.schema import init_params as jinit_params
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import model_zoo as zoo
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import (Request, ServingEngine, SlotSnapshot,
                                        host_column)
from repro_torch.serving.workload import (BATCH, INTERACTIVE, STANDARD,
                                          SLOClass)
from repro_torch.serving.workunit import PACKED, PAUSED, WorkUnit
from repro_torch.vertical import QoSPolicy

torch.set_num_threads(1)

ARCHS = ["granite-8b", "mamba2-780m"]     # causal + ssm families


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS + ["zamba2-2.7b"]:
        cfg = get_config(arch).reduced()
        out[arch] = (cfg, zoo.init_serving_params(cfg, seed=0,
                                                  device="cpu"))
    return out


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n, dtype=np.int32)


def _engine(cfg, params, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_seq", 64)
    return ServingEngine(cfg, params, device="cpu", **kw)


def _reference_tokens(cfg, params, prompt, max_new, **kw):
    eng = _engine(cfg, params, **kw)
    req = Request(rid=99, prompt=prompt.copy(), max_new_tokens=max_new)
    eng.submit(req)
    eng.run_until_idle()
    assert req.done
    return req.out_tokens


def _requests(n, seed=3, plen=(3, 20), max_new=6, vocab=200):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, int(rng.integers(*plen)))
                    .astype(np.int32),
                    max_new_tokens=(max_new if isinstance(max_new, int)
                                    else int(rng.integers(*max_new))))
            for i in range(n)]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


def _bits(t: torch.Tensor) -> np.ndarray:
    """A column's exact bits (bf16 through its int16 view)."""
    t = host_column(t)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _assert_columns_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = _bits(a[k]), _bits(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        assert np.array_equal(x, y), k


# --------------------------------------------------- preempt / resume
@pytest.mark.parametrize("arch", ARCHS)
def test_preempt_resume_mid_decode_bit_identical(models, arch):
    """Pause a slot mid-generation; the resumed stream (on a different
    engine) matches the uninterrupted run exactly."""
    cfg, params = models[arch]
    prompt = _prompt(cfg, 12, seed=1)
    ref = _reference_tokens(cfg, params, prompt, max_new=12)

    eng = _engine(cfg, params)
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=12)
    eng.submit(req)
    while eng.fed_tokens(0) <= len(prompt):      # cross into decode
        eng.step()
    units = eng.preempt()
    assert len(units) == 1
    u = units[0]
    assert u.state == PAUSED
    assert eng.preemptions == 1
    assert eng.n_active == 0                     # slot freed
    assert len(prompt) < u.progress < len(prompt) + 11   # mid-decode

    other = _engine(cfg, params)
    other.resume(units)
    assert u.state == PACKED and other.resumes == 1
    other.run_until_idle()
    assert req.done
    assert req.out_tokens == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_preempt_resume_mid_prefill_chunk_bit_identical(models, arch):
    """Preempt right after the bulk prefill chunk, before the prompt is
    fully fed; the resumed continuation is still exact."""
    cfg, params = models[arch]
    prompt = _prompt(cfg, 30, seed=2)
    ref = _reference_tokens(cfg, params, prompt, max_new=8)

    eng = _engine(cfg, params, prefill_buckets=(16,))
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
    eng.submit(req)
    eng.step()                   # admit: one 16-token chunk + 1 step
    assert eng.chunk_prefills == 1
    assert eng.fed_tokens(0) < len(prompt) - 1   # still mid-prefill
    units = eng.preempt()
    assert len(units) == 1 and units[0].progress < len(prompt)
    assert req.out_tokens == []

    other = _engine(cfg, params)
    other.resume(units)
    other.run_until_idle()
    assert req.done
    assert req.out_tokens == ref


def test_workunit_metadata(models):
    """Identity, SLO class, measured progress and load accounting ride
    the unit across a pack -> unpack hop, and the uid plus the hop
    journal survive a re-pack."""
    cfg, params = models["granite-8b"]
    eng = _engine(cfg, params)
    slo = SLOClass("batch", 2, deadline=100.0, admit_lazily=True)
    req = Request(rid=7, prompt=_prompt(cfg, 6, seed=3),
                  max_new_tokens=10, slo=slo)
    eng.submit(req)
    for _ in range(3):
        eng.step()
    (u,) = eng.pack()
    assert isinstance(u, WorkUnit) and isinstance(u.snapshot, SlotSnapshot)
    assert u.state == PACKED and u.rid == 7
    assert u.slo_name == "batch" and u.preemptible
    assert u.progress == u.snapshot.fed > 0
    assert u.remaining_cost() > 0
    assert u.remaining_tokens == u.snapshot.remaining_tokens \
        == req.total_tokens - u.snapshot.fed
    assert u.n_hops == 0
    u.record_hop(0, 1.0, "interruption")
    other = _engine(cfg, params)
    other.unpack([u])
    assert other.pending_units() == (u,) and other.n_queued == 1
    assert other.restore_costs() == [u.remaining_cost(
        other.prefill_discount)]
    assert other.backlog_tokens() == pytest.approx(other.restore_costs()[0])
    u.record_hop(1, 2.0, "land")
    assert u.n_hops == 2
    assert [(h.rid, h.reason) for h in u.hops] \
        == [(0, "interruption"), (1, "land")]
    other.step()
    assert other.pending_units() == ()
    (prov,) = other.slot_provenance().values()
    assert prov == (u.uid, tuple(u.hops))
    (again,) = other.pack()
    assert again.uid == u.uid and again.origin == u.origin
    assert [h.reason for h in again.hops] == ["interruption", "land"]
    req2 = Request(rid=8, prompt=_prompt(cfg, 6, seed=4),
                   max_new_tokens=10, slo=slo)
    eng2 = _engine(cfg, params)
    eng2.submit(req2)
    eng2.step()
    (fresh,) = eng2.pack()
    assert fresh.uid != again.uid


# --------------------------------------------------------- migration
@pytest.mark.parametrize("arch", ARCHS)
def test_migrate_mid_decode_bit_identical(models, arch):
    """``pack`` of one occupied slot mid-generation -> ``unpack`` into
    another engine; one poll and one cache fetch, as in the reference."""
    cfg, params = models[arch]
    prompt = _prompt(cfg, 12, seed=1)
    ref = _reference_tokens(cfg, params, prompt, max_new=12)

    src = _engine(cfg, params)
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=12)
    src.submit(req)
    while src.fed_tokens(0) <= len(prompt):
        src.step()
    assert len(prompt) < src.fed_tokens(0) < len(prompt) + 11
    occupied = [s for s, _ in src.slot_costs()]
    syncs = src.host_syncs
    units = src.pack(occupied[:1])
    assert src.host_syncs == syncs + 2          # the poll + the columns
    assert len(units) == 1
    assert 0 < len(req.out_tokens) < 12         # the pack's poll
    assert src.n_active == 0
    assert int(src.sample.active[occupied[0]]) == 0

    dst = _engine(cfg, params)
    dst.unpack(units)
    dst.run_until_idle()
    assert req.done
    assert req.out_tokens == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_migrate_mid_prefill_chunk_bit_identical(models, arch):
    cfg, params = models[arch]
    prompt = _prompt(cfg, 30, seed=2)
    ref = _reference_tokens(cfg, params, prompt, max_new=8)

    eng = _engine(cfg, params, prefill_buckets=(16,))
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
    eng.submit(req)
    eng.step()
    assert eng.chunk_prefills == 1
    assert eng.fed_tokens(0) < len(prompt) - 1
    units = eng.pack()
    assert len(units) == 1 and units[0].progress < len(prompt)
    assert req.out_tokens == []

    dst = _engine(cfg, params)
    dst.unpack(units)
    dst.run_until_idle()
    assert req.done
    assert req.out_tokens == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_double_migration_bit_identical(models, arch):
    """Two hops (src -> mid -> dst), one mid-prefill and one mid-decode."""
    cfg, params = models[arch]
    prompt = _prompt(cfg, 24, seed=3)
    ref = _reference_tokens(cfg, params, prompt, max_new=10)

    src = _engine(cfg, params, prefill_buckets=(16,))   # a streamed tail
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=10)
    src.submit(req)
    src.step()                                   # hop 1: mid-prefill
    units = src.pack([s for s, _ in src.slot_costs()])
    mid = _engine(cfg, params)
    mid.unpack(units)
    while mid.fed_tokens(0) <= len(prompt):
        mid.step()
    assert mid.fed_tokens(0) > len(prompt)       # hop 2: mid-decode
    units = mid.pack([s for s, _ in mid.slot_costs()])
    assert 0 < len(req.out_tokens) < 10
    dst = _engine(cfg, params)
    dst.unpack(units)
    dst.run_until_idle()
    assert req.done
    assert req.out_tokens == ref


def test_selective_snapshot_leaves_other_slots_running(models):
    """``pack([victim])`` must not disturb the co-resident slot."""
    cfg, params = models["granite-8b"]
    p0, p1 = _prompt(cfg, 6, seed=4), _prompt(cfg, 6, seed=5)
    ref0 = _reference_tokens(cfg, params, p0, max_new=10)
    ref1 = _reference_tokens(cfg, params, p1, max_new=10)

    src = _engine(cfg, params)
    r0 = Request(rid=0, prompt=p0.copy(), max_new_tokens=10)
    r1 = Request(rid=1, prompt=p1.copy(), max_new_tokens=10)
    src.submit(r0)
    src.submit(r1)
    for _ in range(2):
        src.step()
    assert src.n_active == 2
    victim = [s for s, _ in src.slot_costs() if src._slots[s].rid == 0]
    units = src.pack(victim)
    assert [u.rid for u in units] == [0]
    assert src.n_active == 1

    dst = _engine(cfg, params)
    dst.unpack(units)
    dst.run_until_idle()
    src.run_until_idle()
    assert r0.done and r0.out_tokens == ref0
    assert r1.done and r1.out_tokens == ref1


# ------------------------------------------- geometry (test_paged.py)
@pytest.mark.parametrize("arch", ARCHS + ["zamba2-2.7b"])
def test_cross_block_size_migration(models, arch):
    """Mid-decode pack from block_size=4, unpack into block_size=16:
    resumed streams match the uninterrupted dense run exactly."""
    cfg, params = models[arch]
    kw = dict(batch_size=3, max_seq=96, prefill_buckets=(16, 64))
    mk = lambda: _requests(3, seed=3, plen=(5, 30),       # noqa: E731
                           max_new=(6, 12))
    ref = _run(_engine(cfg, params, **kw), mk())
    reqs = mk()
    src = _engine(cfg, params, cache_mode="paged", block_size=4, **kw)
    for r in reqs:
        src.submit(r)
    src.step_many(3)
    units = src.pack()
    assert units and src.n_active == 0
    src._alloc.check_invariants()
    assert src._alloc.free_count == src.pool_blocks   # all returned
    dst = _engine(cfg, params, cache_mode="paged", block_size=16, **kw)
    dst.unpack(units)
    dst.run_until_idle()
    assert [list(r.out_tokens) for r in reqs] == ref


@pytest.mark.parametrize("src_mode,dst_mode", [("paged", "dense"),
                                               ("dense", "paged")])
def test_dense_paged_migration(models, src_mode, dst_mode):
    cfg, params = models["granite-8b"]
    kw = dict(batch_size=3, max_seq=96, prefill_buckets=(16, 64))
    mk = lambda: _requests(3, seed=5, plen=(6, 20),       # noqa: E731
                           max_new=(5, 9))
    ref = _run(_engine(cfg, params, **kw), mk())
    reqs = mk()
    src = _engine(cfg, params, cache_mode=src_mode, block_size=8, **kw)
    for r in reqs:
        src.submit(r)
    src.step_many(4)
    units = src.pack()
    dst = _engine(cfg, params, cache_mode=dst_mode, block_size=8, **kw)
    dst.unpack(units)
    dst.run_until_idle()
    assert [list(r.out_tokens) for r in reqs] == ref


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-2.7b"])
def test_repack_before_step_returns_columns_bitwise(models, arch):
    """paged (block 8) -> dense -> paged (block 16) -> paged (block 8):
    a unit unpacked and packed again before any step comes back with
    every column bit for bit, in the canonical layout (sequence axes
    padded to max_seq, the kv leaves' batch axis removed)."""
    cfg, params = models[arch]
    kw = dict(batch_size=3, max_seq=64, prefill_buckets=(16,))
    src = _engine(cfg, params, cache_mode="paged", block_size=8, **kw)
    for r in _requests(3, seed=8, plen=(5, 30), max_new=(6, 12)):
        src.submit(r)
    src.step_many(3)
    units = src.pack()
    first = {u.rid: u.snapshot.cache for u in units}
    for k, col in units[0].snapshot.cache.items():
        leaf = src.state.cache[k]
        assert col.device.type == "cpu" and col.dtype == leaf.dtype
        ax = src._cache_axes[k]
        if k in ("k", "v"):
            assert col.shape[ax] == 64
    for mode, bs in (("dense", 8), ("paged", 16), ("paged", 8)):
        eng = _engine(cfg, params, cache_mode=mode, block_size=bs, **kw)
        eng.unpack(units)
        eng._admit()
        units = eng.pack()
        for u in units:
            _assert_columns_equal(u.snapshot.cache, first[u.rid])


@pytest.mark.parametrize("script_seed", range(3))
def test_engine_interleaving_never_leaks_blocks(models, script_seed):
    """Fixed-seed admit/step/preempt/resume/pack interleavings on a live
    paged engine (the reference draws them from hypothesis): the
    allocator partition holds after every op, and a drained engine has
    every block back in the pool."""
    cfg, params = models["granite-8b"]
    eng = _engine(cfg, params, batch_size=3, max_seq=96,
                  prefill_buckets=(16, 64), cache_mode="paged",
                  block_size=8, kv_pool_blocks=18)
    script = np.random.default_rng(100 + script_seed).integers(0, 5, 12)
    rng = np.random.default_rng(0)
    rid = [0]
    parked = []

    def submit():
        eng.submit(Request(rid=rid[0],
                           prompt=rng.integers(1, 250, int(
                               rng.integers(3, 14))).astype(np.int32),
                           max_new_tokens=int(rng.integers(3, 7))))
        rid[0] += 1

    for op in script:
        if op == 0:
            submit()
        elif op == 1:
            eng.step_many(2)
        elif op == 2:
            occupied = [s for s, r in enumerate(eng._slots)
                        if r is not None]
            if occupied:
                parked.extend(eng.preempt(occupied[:1]))
        elif op == 3 and parked:
            eng.resume([parked.pop(0)])
        elif op == 4:
            eng.unpack(eng.pack())
        eng._alloc.check_invariants()
        assert eng._alloc.in_use <= eng.pool_blocks
    eng.resume(parked)
    eng.run_until_idle()
    eng._alloc.check_invariants()
    assert eng._alloc.free_count == eng.pool_blocks


# -------------------------------------------- resize (test_vertical.py)
def _vertical_ref(cfg, params, n, **kw):
    reqs = _requests(n)
    return _run(_engine(cfg, params, **dict(kw, batch_size=n)), reqs)


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-2.7b"])
def test_grow_mid_flight_bit_identical(models, arch):
    """Grow 2 -> 4 lanes mid-decode: the surviving streams and the newly
    admitted queue both finish as a never-resized engine does."""
    cfg, params = models[arch]
    ref = _vertical_ref(cfg, params, 4)
    reqs = _requests(4)
    eng = _engine(cfg, params, batch_size=2)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    evicted = eng.resize(batch_size=4)
    assert evicted == [] and eng.resizes == 1
    assert eng.batch == 4 and eng.sample.active.shape == (4,)
    eng.run_until_idle()
    assert [list(r.out_tokens) for r in reqs] == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_shrink_evict_resume_bit_identical(models, arch):
    """Shrink 4 -> 2 evicts the least-progressed units as PAUSED;
    resuming them continues every stream bit-identically."""
    cfg, params = models[arch]
    ref = _vertical_ref(cfg, params, 4)
    reqs = _requests(4)
    eng = _engine(cfg, params, batch_size=4)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    evicted = eng.resize(batch_size=2)
    assert len(evicted) == 2 and eng.resize_evictions == 2
    assert all(u.state is PAUSED for u in evicted)
    eng.resume(evicted)
    eng.run_until_idle()
    assert [list(r.out_tokens) for r in reqs] == ref


def test_paged_resize_grow_shrink_and_pool(models):
    """Paged cache: grow re-pools by default, an explicit kv_pool_blocks
    resize re-blocks through the canonical snapshot path (the pool, its
    sink row and the tables' sentinel follow the new size, and the old
    geometry's decode loops are dropped), and the allocator's partition
    stays exact across every transition."""
    cfg, params = models["granite-8b"]
    paged = dict(max_seq=64, cache_mode="paged", block_size=8)
    ref = _vertical_ref(cfg, params, 4, **paged)
    reqs = _requests(4)
    eng = _engine(cfg, params, batch_size=2, **paged)
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    assert eng._loops
    assert eng.resize(batch_size=4) == []     # grow: default pool scales
    assert eng.pool_blocks == 4 * eng.max_blocks
    eng._alloc.check_invariants()
    for _ in range(2):
        eng.step()
    # explicit pool change (same lanes): pure re-block, nothing evicted
    pool = 4 * eng.max_blocks + 3
    assert eng.resize(kv_pool_blocks=pool) == []
    assert eng.state.cache["k"].shape[1] == pool + 1      # + the sink row
    assert not eng._loops and not eng._prefills
    free = [s for s, r in enumerate(eng._slots) if r is None]
    assert all((eng._tables[s] == pool).all() for s in free)
    eng._alloc.check_invariants()
    evicted = eng.resize(batch_size=2)        # shrink evicts two
    assert len(evicted) == 2
    eng._alloc.check_invariants()
    eng.resume(evicted)
    eng.run_until_idle()
    eng._alloc.check_invariants()
    assert [list(r.out_tokens) for r in reqs] == ref


def test_decode_block_only_resize_is_free(models):
    """Changing only the decode window repacks nothing."""
    cfg, params = models["granite-8b"]
    ref = _vertical_ref(cfg, params, 2)
    reqs = _requests(2)
    eng = _engine(cfg, params, batch_size=2)
    for r in reqs:
        eng.submit(r)
    eng.step()
    syncs, state = eng.host_syncs, eng.state
    assert eng.resize(decode_block=1) == []
    assert eng.decode_block == 1 and eng.resizes == 0
    assert eng.host_syncs == syncs and eng.state is state
    eng.run_until_idle()
    assert [list(r.out_tokens) for r in reqs] == ref


def test_resize_rejects_bad_geometry(models):
    cfg, params = models["granite-8b"]
    dense = _engine(cfg, params)
    with pytest.raises(ValueError, match="paged"):
        dense.resize(kv_pool_blocks=64)
    paged = _engine(cfg, params, cache_mode="paged", block_size=8)
    with pytest.raises(ValueError, match="full request"):
        paged.resize(kv_pool_blocks=paged.max_blocks - 1)
    with pytest.raises(ValueError):
        paged.resize(batch_size=0)


def test_resize_interleaving_conserves_blocks_paged(models):
    """The reference's seeded resize/preempt/resume/step interleaving on
    a paged engine: every request finishes, the allocator's partition
    stays exact, and every stream equals a never-resized run's."""
    cfg, params = models["granite-8b"]
    paged = dict(max_seq=64, cache_mode="paged", block_size=8)
    ref = _run(_engine(cfg, params, batch_size=6, **paged),
               _requests(6, seed=0, max_new=5))
    rng = np.random.default_rng(0)
    eng = _engine(cfg, params, batch_size=3, **paged)
    reqs = _requests(6, seed=0, max_new=5)
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
        eng._alloc.check_invariants()
    eng.resume(paused)
    eng.run_until_idle()
    eng._alloc.check_invariants()
    assert eng._alloc.in_use == 0
    assert [list(r.out_tokens) for r in reqs] == ref


def test_qos_shrink_evicts_best_effort_first(models):
    """The engine-level half of the reference's QoS case: a shrink keyed
    BestEffort-first takes batch work before interactive, even when the
    interactive stream has made less progress, under the QoS layer's
    key (``QoSPolicy.evict_key``: tier rank, then progress, then uid)."""
    cfg, params = models["granite-8b"]
    eng = _engine(cfg, params, batch_size=4)
    slos = [BATCH, INTERACTIVE, BATCH, STANDARD]
    reqs = [Request(rid=i, prompt=np.arange(3, dtype=np.int32) + 1,
                    max_new_tokens=8, slo=s) for i, s in enumerate(slos)]
    for r in reqs[1:]:
        eng.submit(r)
    eng.step()
    eng.submit(reqs[0])          # a late batch stream (least fed)
    eng.step()
    evicted = eng.resize(batch_size=2, evict_key=QoSPolicy.evict_key)
    assert [u.slo_name for u in evicted] == ["batch", "batch"]
    assert {r.slo.name for _, r in eng.slot_requests()} == {
        "interactive", "standard"}


# ------------------------------------------ what pack leaves behind
def test_pack_leaves_queued_work_behind(models):
    """``pack`` takes occupied slots only: a request still in the queue,
    and a unit still in the restore queue, stay in the engine (the
    reference's interleaving property fails on exactly this)."""
    cfg, params = models["granite-8b"]
    eng = _engine(cfg, params)
    req = Request(rid=0, prompt=_prompt(cfg, 10, seed=4),
                  max_new_tokens=10)
    eng.submit(req)
    assert eng.pack() == [] and eng.preempt() == []
    assert eng.queued_requests() == (req,) and eng.host_syncs == 0
    eng.step()
    (u,) = eng.pack()
    other = _engine(cfg, params)
    other.unpack([u])
    assert other.pack() == []                 # not admitted yet
    assert other.pending_units() == (u,) and other.n_queued == 1


def test_drain_units_takes_everything(models):
    """``drain_units`` empties the engine: the packed slots, the restore
    queue's units as they are (same objects, same uids) and the request
    queue; the stream then continues exactly elsewhere."""
    cfg, params = models["granite-8b"]
    prompts = [_prompt(cfg, 10, seed=s) for s in (4, 5, 6)]
    refs = [_reference_tokens(cfg, params, p, max_new=10) for p in prompts]
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=10)
            for i, p in enumerate(prompts)]
    a = _engine(cfg, params)
    a.submit(reqs[0])
    a.step()
    (parked,) = a.pack()
    eng = _engine(cfg, params, batch_size=1)
    eng.submit(reqs[1])
    eng.step()                                # reqs[1] occupies the lane
    eng.unpack([parked])
    eng.submit(reqs[2])
    units, queued = eng.drain_units()
    assert [u.rid for u in units] == [1, 0] and units[1] is parked
    assert queued == [reqs[2]]
    assert eng.n_active == 0 and eng.n_queued == 0
    dst = _engine(cfg, params, batch_size=3)
    dst.unpack(units)
    for r in queued:
        dst.submit(r)
    dst.run_until_idle()
    assert [r.out_tokens for r in reqs] == refs


# ------------------------------------------------- sampled recovery
@pytest.mark.parametrize("arch", ["granite-8b", "zamba2-2.7b"])
def test_checkpoint_replays_sampled_stream(models, arch):
    """Temperature > 0: a stream restored from ``checkpoint_units`` into
    an empty engine (another seed) replays the lost tail bit for bit,
    because the unit carries the generator's state; the live slot keeps
    decoding undisturbed."""
    cfg, params = models[arch]
    kw = dict(temperature=0.9, batch_size=2, max_seq=64)
    prompt = _prompt(cfg, 9, seed=7)
    eng = _engine(cfg, params, seed=3, **kw)
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=14)
    eng.submit(req)
    for _ in range(4):
        eng.step()
    (u,) = eng.checkpoint_units()
    assert isinstance(u.snapshot.rng, torch.Tensor)
    assert u.snapshot.request is not req
    assert u.snapshot.request.out_tokens == req.out_tokens
    # the same checkpoint without the generator's state, for contrast
    bare = WorkUnit(snapshot=dataclasses.replace(
        u.snapshot, rng=None, request=dataclasses.replace(
            u.snapshot.request,
            out_tokens=list(u.snapshot.request.out_tokens))))
    eng.run_until_idle()
    assert req.done
    for unit in (u, bare):
        dst = _engine(cfg, params, seed=11, **kw)
        dst.unpack([unit])
        dst.run_until_idle()
        assert unit.snapshot.request.done
    assert u.snapshot.request.out_tokens == req.out_tokens
    assert bare.snapshot.request.out_tokens != req.out_tokens


def test_foreign_rng_raises_only_when_it_would_be_applied(models):
    """A snapshot rng that is not a torch generator state (a JAX key)
    is never read by a greedy engine, and refused by a sampled one."""
    cfg, params = models["granite-8b"]
    eng = _engine(cfg, params)
    eng.submit(Request(rid=0, prompt=_prompt(cfg, 6, seed=1),
                       max_new_tokens=8))
    eng.step()
    (u,) = eng.checkpoint_units()
    u.snapshot.rng = np.array([0, 42], np.uint32)
    greedy = _engine(cfg, params)
    greedy.unpack([u])
    greedy.run_until_idle()
    sampled = _engine(cfg, params, temperature=0.5)
    sampled.unpack([u])
    with pytest.raises(ValueError, match="torch.Generator"):
        sampled.step()


# ------------------------------------------------- across packages
def _cross_models(arch, **kw):
    jcfg = jax_config(arch).reduced().with_(**kw)
    tcfg = get_config(arch).reduced().with_(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    # one jitted init: eager per-leaf draws take seconds more at zamba2
    schema = jtransformer.model_schema(jcfg)
    jparams = jax.jit(lambda key: jinit_params(schema, key, jcfg.param_dtype))(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def f32_granite():
    return _cross_models("granite-8b", compute_dtype="float32")


CROSS = dict(batch_size=3, max_seq=64, prefill_buckets=(16,),
             cache_mode="paged", block_size=8)


def _cross_requests(cls, seed=21):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, 250, n).astype(np.int32),
                max_new_tokens=m)
            for i, (n, m) in enumerate(((5, 9), (20, 7), (35, 8)))]


def _jax_columns(cols):
    """The port's columns as the JAX engine reads them: numpy, bf16 as
    ``ml_dtypes.bfloat16`` (the conversion is the test's, not the
    port's)."""
    out = {}
    for k, t in cols.items():
        if t.dtype == torch.bfloat16:
            out[k] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[k] = t.numpy()
    return out


def _to_jax_units(units):
    for u in units:
        u.snapshot.cache = _jax_columns(u.snapshot.cache)
    return units


def test_jax_unit_continues_in_port_f32(f32_granite):
    """A unit packed mid-decode by the JAX engine unpacks into the port:
    the float32 greedy stream continues token for token like an
    unmigrated JAX run, the pack costs both engines the same host
    syncs, and the columns cross bit for bit."""
    jcfg, jparams, tcfg, tparams = f32_granite
    ref = _run(JEngine(jcfg, jparams, **CROSS), _cross_requests(JRequest))
    reqs = _cross_requests(JRequest)
    src = JEngine(jcfg, jparams, **CROSS)
    for r in reqs:
        src.submit(r)
    src.step_many(3)
    units = src.pack()
    port_src = ServingEngine(tcfg, tparams, device="cpu", **CROSS)
    for r in _cross_requests(Request):
        port_src.submit(r)
    port_src.step_many(3)
    port_src.pack()
    assert port_src.host_syncs == src.host_syncs
    jcols = {u.rid: dict(u.snapshot.cache) for u in units}
    dst = ServingEngine(tcfg, tparams, device="cpu",
                        **dict(CROSS, block_size=16))
    dst.unpack(units)
    dst._admit()
    again = dst.pack()
    for u in again:
        _assert_columns_equal(u.snapshot.cache, jcols[u.rid])
    dst.unpack(again)
    dst.run_until_idle()
    assert [list(r.out_tokens) for r in reqs] == ref


def test_port_unit_continues_in_jax_f32(f32_granite):
    """The other direction: a unit packed by the port unpacks into the
    JAX engine (bf16 columns converted by the test) and the float32
    greedy stream continues like an unmigrated port run."""
    jcfg, jparams, tcfg, tparams = f32_granite
    ref = _run(ServingEngine(tcfg, tparams, device="cpu", **CROSS),
               _cross_requests(Request))
    reqs = _cross_requests(Request)
    src = ServingEngine(tcfg, tparams, device="cpu", **CROSS)
    for r in reqs:
        src.submit(r)
    src.step_many(3)
    units = src.pack()
    tcols = {u.rid: dict(u.snapshot.cache) for u in units}
    dst = JEngine(jcfg, jparams, **dict(CROSS, cache_mode="dense"))
    dst.unpack(_to_jax_units(units))
    dst._admit()
    again = dst.pack()
    for u in again:
        _assert_columns_equal(u.snapshot.cache, tcols[u.rid])
    dst.unpack(again)
    dst.run_until_idle()
    assert [list(r.out_tokens) for r in reqs] == ref


BF16_CROSS = ["mamba2-780m", "zamba2-2.7b"]


@functools.lru_cache(maxsize=None)
def _bf16_models(arch):
    return _cross_models(arch)


# short prompts fed by the decode loop itself, so that the JAX engine
# compiles one function (the decode loop) and the test stays small
STREAMED = dict(CROSS, prefill_buckets=())


def _packed_mid_decode(engine, request_cls):
    rng = np.random.default_rng(23)
    reqs = [request_cls(rid=i, prompt=rng.integers(1, 250, n)
                        .astype(np.int32), max_new_tokens=8)
            for i, n in enumerate((3, 4, 6))]
    for r in reqs:
        engine.submit(r)
    engine.step_many(6)
    return reqs, engine.pack()


@pytest.mark.parametrize("arch", BF16_CROSS)
def test_port_unit_into_jax_bitwise_bf16(arch):
    """The other direction: the port's units, their bf16 columns
    converted by the test, install into the JAX engine and pack back bit
    for bit."""
    jcfg, jparams, tcfg, tparams = _bf16_models(arch)
    tsrc = ServingEngine(tcfg, tparams, device="cpu", **STREAMED)
    _, tunits = _packed_mid_decode(tsrc, Request)
    tcols = {u.rid: dict(u.snapshot.cache) for u in tunits}
    into_jax = JEngine(jcfg, jparams, **STREAMED)
    into_jax.unpack(_to_jax_units(tunits))
    into_jax._admit()
    for u in into_jax.pack():
        _assert_columns_equal(u.snapshot.cache, tcols[u.rid])


@pytest.mark.parametrize("arch", BF16_CROSS)
def test_jax_unit_into_port_bitwise_bf16(arch):
    """bf16 (the reference serves ssm and hybrid in bf16 only): units
    packed by the JAX engine unpack into the port, and packed again
    before any step they come back with every column bit for bit: the
    float32 ssm state and the bf16 conv and kv leaves.  The pack costs
    both packages the same host syncs; the streams run to their token
    counts (bf16 rounds in other places in the two frameworks, so they
    are not held equal; test_torch_engine.py)."""
    jcfg, jparams, tcfg, tparams = _bf16_models(arch)
    jsrc = JEngine(jcfg, jparams, **STREAMED)
    tsrc = ServingEngine(tcfg, tparams, device="cpu", **STREAMED)
    jreqs, junits = _packed_mid_decode(jsrc, JRequest)
    _, tunits = _packed_mid_decode(tsrc, Request)
    assert tsrc.host_syncs == jsrc.host_syncs
    dtypes = {k: v.dtype for k, v in tunits[0].snapshot.cache.items()}
    assert dtypes["ssm"] == torch.float32 and dtypes["conv"] == torch.bfloat16
    jcols = {u.rid: dict(u.snapshot.cache) for u in junits}
    into_port = ServingEngine(tcfg, tparams, device="cpu", **STREAMED)
    into_port.unpack(junits)
    into_port._admit()
    back = into_port.pack()
    for u in back:
        _assert_columns_equal(u.snapshot.cache, jcols[u.rid])
    into_port.unpack(back)
    into_port.run_until_idle()
    assert all(r.done and len(r.out_tokens) == r.max_new_tokens
               for r in jreqs)
