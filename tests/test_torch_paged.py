"""The port's paged KV cache engine: the cases of ``test_paged.py`` that
no other port test holds under another name.

Reduced ``granite-8b`` in float32, the JAX weights carried into the port
(``tests._torch_parity.f32_models``), engines on ``device="cpu"``:

* prompts past the largest bucket go in as several state-continued
  chunks and a pool far smaller than lanes x max_seq gates admission on
  free blocks, both giving the dense engine's streams bit for bit;
* the ``BlockAllocator`` keeps free + owned an exact partition of the
  pool under seeded allocate / release scripts, and misuse raises;
* a steady paged decode window makes no host sync;
* ``occupancy()`` threads into ``ClusterMetrics.summary()`` with the
  reference engine's numbers for the same run, and a dense engine
  reports slots only.

The kernel cases, engine equality across families, cross-block-size and
paged-to-dense migration and the engine interleavings are in
``test_torch_{paged_attention,engine,workunit}.py``.
"""

import numpy as np
import pytest
import torch

from repro.cluster import ClusterMetrics as JMetrics
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.cluster import ClusterMetrics
from repro_torch.serving.engine import BlockAllocator, Request, ServingEngine
from tests._torch_parity import f32_models

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return f32_models()


@pytest.fixture(scope="module")
def model(models):
    return models["torch"]


def _requests(n, seed=0, plen=(3, 24), max_new=(4, 10), vocab=250,
              cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(
                1, vocab, rng.integers(*plen)).astype(np.int32),
                max_new_tokens=int(rng.integers(*max_new)))
            for i in range(n)]


def _run(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    assert all(r.done for r in reqs)
    return {r.rid: list(r.out_tokens) for r in reqs}


def _engine(cfg, params, cls=ServingEngine, **kw):
    kw.setdefault("batch_size", 3)
    kw.setdefault("max_seq", 96)
    kw.setdefault("prefill_buckets", (16, 64))
    if cls is ServingEngine:
        kw["device"] = "cpu"
    return cls(cfg, params, **kw)


# ----------------------------------------------------- engine equivalence
def test_multichunk_long_prompt_bit_identical(model):
    """Prompts beyond the largest bucket: the paged engine appends several
    state-continued chunks and still matches dense exactly."""
    cfg, params = model
    dense = _run(_engine(cfg, params),
                 _requests(3, seed=7, plen=(70, 93), max_new=(3, 6)))
    eng = _engine(cfg, params, cache_mode="paged", block_size=8)
    paged = _run(eng, _requests(3, seed=7, plen=(70, 93), max_new=(3, 6)))
    assert dense == paged
    assert eng.chunk_prefills > 3            # > one chunk per request


def test_small_pool_capacity_gated(model):
    """A pool far smaller than lanes x max_seq still completes every
    request bit-identically: admission queues on free blocks instead of
    overcommitting."""
    cfg, params = model
    mk = lambda: _requests(6, seed=9, plen=(3, 12),       # noqa: E731
                           max_new=(3, 6))
    dense = _run(_engine(cfg, params), mk())
    eng = _engine(cfg, params, cache_mode="paged", block_size=8,
                  kv_pool_blocks=6)
    assert _run(eng, mk()) == dense
    assert eng.occupancy()["peak_blocks_in_use"] <= 6


# -------------------------------------------------------- block lifecycle
def _allocator_script(seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 2)), int(rng.integers(0, 8)),
             int(rng.integers(1, 7)))
            for _ in range(int(rng.integers(0, 61)))]


@pytest.mark.parametrize("seed", range(50))
def test_block_allocator_never_leaks(seed):
    """Allocate / release scripts (the reference draws 50 from
    hypothesis; here 50 seeded ones) keep free + owned an exact partition
    of the pool; misuse raises instead of corrupting."""
    alloc = BlockAllocator(16)
    for kind, slot, n in _allocator_script(seed):
        if kind == 0:
            if slot in alloc._owned or not alloc.can_allocate(n):
                with pytest.raises(ValueError):
                    alloc.allocate(slot, n)
            else:
                blocks = alloc.allocate(slot, n)
                assert len(blocks) == len(set(blocks)) == n
        else:
            if slot in alloc._owned:
                alloc.release(slot)
            else:
                with pytest.raises(ValueError):
                    alloc.release(slot)
        alloc.check_invariants()
    assert alloc.peak_in_use <= alloc.num_blocks


# ------------------------------------------------------------- zero-sync
def test_paged_steady_state_is_sync_free(model):
    cfg, params = model
    eng = ServingEngine(cfg, params, cache_mode="paged", block_size=8,
                        batch_size=2, max_seq=96, prefill_buckets=(16,),
                        device="cpu")
    for r in _requests(2, seed=1, plen=(4, 8), max_new=(40, 41)):
        eng.submit(r)
    eng.step_many(4)                       # admission window
    syncs0 = eng.host_syncs
    for _ in range(5):
        eng.step_many(4)                   # nobody completes here
    assert eng.host_syncs == syncs0
    eng.run_until_idle()
    assert eng.host_syncs > syncs0


# ----------------------------------------------------- occupancy metrics
def test_occupancy_threads_into_cluster_summary(models):
    """A drained paged engine's occupancy, and the cluster summary keys it
    feeds, are the reference engine's for the same run."""
    occs, summaries = [], []
    for pkg, E, R, M in (("torch", ServingEngine, Request, ClusterMetrics),
                         ("jax", JEngine, JRequest, JMetrics)):
        cfg, params = models[pkg]
        eng = _engine(cfg, params, cls=E, cache_mode="paged", block_size=8)
        _run(eng, _requests(5, seed=4, cls=R))
        occ = eng.occupancy()
        metrics = M()
        metrics.on_launch(0, "t.small")
        metrics.on_occupancy(0, occ)
        metrics.on_occupancy(99, occ)      # unknown replica: ignored
        summary = metrics.summary(now=1.0)
        occs.append(occ)
        summaries.append({k: summary[k] for k in ("max_concurrent_slots",
                                                  "peak_block_occupancy")})
    occ = occs[0]
    assert occ["max_concurrent_slots"] >= 1
    assert 0 < occ["peak_blocks_in_use"] <= occ["pool_blocks"]
    assert occ["active_slots"] == occ["blocks_in_use"] == 0   # drained
    assert summaries[0]["max_concurrent_slots"] == \
        occ["max_concurrent_slots"]
    assert summaries[0]["peak_block_occupancy"] == pytest.approx(
        occ["peak_blocks_in_use"] / occ["pool_blocks"])
    assert occs[0] == occs[1]
    assert summaries[0] == summaries[1]


def test_dense_engine_occupancy_is_slot_only(model):
    cfg, params = model
    eng = _engine(cfg, params)
    _run(eng, _requests(4, seed=6))
    occ = eng.occupancy()
    assert occ["max_concurrent_slots"] >= 1
    assert occ["pool_blocks"] == occ["peak_blocks_in_use"] == 0
