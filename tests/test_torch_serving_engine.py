"""The port's serving engine hot path: the cases of
``test_serving_engine.py`` (and ``test_system.py``'s end-to-end engine
run) on ``repro_torch.serving.engine``.

Reduced ``granite-8b`` in float32, the JAX weights carried into the port
(``tests._torch_parity.f32_models``), engines on ``device="cpu"``:

* **Equivalence**: chunked bulk prefill gives the streamed baseline's
  tokens for prompts below, at and across the (16, 64) buckets, and the
  scattered bf16 cache columns themselves are within one bf16 ulp of the
  streamed ones over the fed positions; a slot packed mid-prefill-chunk
  resumes on another engine to the uninterrupted continuation.
* **Sync-free decode**: steady ``step_many`` windows make no
  device->host fetch (``ServingEngine._fetch`` is the engine's only
  path to the host, and ``host_syncs`` counts it); the host's progress
  projection equals the device's ``fed``.
* **Load signals**: the backlog discounts prefill tokens as
  ``request_cost`` does (a streamed engine does not), with the
  reference engine's numbers for the same requests; bucket selection
  (``_pick_chunk``) pads short chunks for attention families and takes
  the largest fully real bucket for recurrent ones.
* **EOS early exit**, on dense and paged engines: the engine ends in
  fewer fused steps with the stream cut at the first EOS, a batchmate
  is untouched, and streams, step counts and host syncs equal the
  reference engine's for the same weights.
"""

import numpy as np
import pytest
import torch

from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import Request, ServingEngine, request_cost
from tests._torch_parity import f32_models

torch.set_num_threads(1)

PAGED = dict(cache_mode="paged", block_size=8)


@pytest.fixture(scope="module")
def models():
    return f32_models()


@pytest.fixture(scope="module")
def model(models):
    return models["torch"]


def _prompt(n, seed=0, vocab=200):
    return np.random.default_rng(seed).integers(0, vocab, n, dtype=np.int32)


def _serve(cfg, params, prompts, *, mode, max_seq=96, max_new=6,
           single_step=False, **kw):
    eng = ServingEngine(cfg, params, batch_size=2, max_seq=max_seq,
                        prefill_mode=mode, device="cpu", **kw)
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    if single_step:
        steps = 0
        while (eng.n_active or eng.n_queued) and steps < 10_000:
            eng.step()
            steps += 1
    else:
        eng.run_until_idle()
    return reqs, eng


# ------------------------------------------------------------ equivalence
def test_chunked_prefill_bit_identical_to_streamed(model):
    """Prompts below / at / across the bucket sizes, mixed in one batch:
    the bulk-prefilled engine (multi-step fused windows) emits exactly
    the streamed single-step baseline's tokens."""
    cfg, params = model
    lens = (2, 5, 16, 17, 40, 65)       # buckets are (16, 64) at max_seq=96
    prompts = [_prompt(n, seed=n) for n in lens]
    streamed, _ = _serve(cfg, params, prompts, mode="streamed",
                         single_step=True)
    chunked, eng = _serve(cfg, params, prompts, mode="chunked")
    assert eng.chunk_prefills > 0
    for a, b in zip(streamed, chunked):
        assert a.done and b.done
        assert a.out_tokens == b.out_tokens, (len(a.prompt), a.out_tokens,
                                              b.out_tokens)


def test_bulk_prefill_cache_matches_streamed_cache():
    """The scattered cache columns themselves agree with the streamed
    ones over the fed positions, not just the sampled tokens.  In bf16,
    as the reference runs it (in float32 a prefill's attention reads
    float32 k and v where a streamed step reads the bf16 cache, in both
    packages, so the columns differ by design).  The reference's are
    bit-identical; the port's within one bf16 ulp: the CPU's bf16 GEMM
    sums a 33-row chunk in another order than a 1-row step (ROADMAP §3,
    "bf16 streams after an in-place resize")."""
    cfg = get_config("granite-8b").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    prompt = _prompt(33, seed=7)
    snaps = {}
    for mode in ("streamed", "chunked"):
        eng = ServingEngine(cfg, params, batch_size=2, max_seq=96,
                            prefill_mode=mode, device="cpu")
        eng.submit(Request(rid=0, prompt=prompt.copy(), max_new_tokens=4))
        while eng.fed_tokens(0) < len(prompt):
            eng.step()
        snaps[mode] = eng.drain_units()[0][0].snapshot
    a, b = snaps["streamed"], snaps["chunked"]
    assert a.fed == b.fed and a.next_tok == b.next_tok
    for k in a.cache:
        axes = [ax for ax in zoo.decode_state_logical_axes(cfg).cache[k]
                if ax != "cache_batch"]
        av, bv = a.cache[k], b.cache[k]
        if "cache_seq" in axes:
            ax = axes.index("cache_seq")
            av, bv = av.narrow(ax, 0, a.fed), bv.narrow(ax, 0, a.fed)
        assert av.dtype == bv.dtype == torch.bfloat16, k
        torch.testing.assert_close(av.float(), bv.float(), rtol=2.0 ** -7,
                                   atol=1e-6, msg=k)


def test_snapshot_mid_prefill_chunk_resumes_identically(model):
    """Drain a slot right after its bulk prefill chunk, before the prompt
    is fully fed: the restored continuation matches an uninterrupted run
    bit for bit."""
    cfg, params = model
    prompt = _prompt(40, seed=9)        # buckets (16,): chunk 16, tail 23
    ref, _ = _serve(cfg, params, [prompt], mode="chunked", max_new=8)

    eng = ServingEngine(cfg, params, batch_size=2, max_seq=96,
                        prefill_mode="chunked", prefill_buckets=(16,),
                        device="cpu")
    req = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
    eng.submit(req)
    eng.step()                          # admit: bulk chunk of 16 + 1 step
    assert eng.chunk_prefills == 1
    assert eng.fed_tokens(0) < len(prompt) - 1     # still mid-prefill
    units, queued = eng.drain_units()
    assert len(units) == 1 and not queued
    assert units[0].progress < len(prompt)
    assert req.out_tokens == []

    other = ServingEngine(cfg, params, batch_size=2, max_seq=96,
                          prefill_mode="chunked", device="cpu")
    other.unpack(units)
    other.run_until_idle()
    assert req.done
    assert req.out_tokens == ref[0].out_tokens


# ------------------------------------------------------------- sync-free
def _count_fetches(eng, monkeypatch):
    fetches = []
    real = eng._fetch
    monkeypatch.setattr(eng, "_fetch",
                        lambda tensors: fetches.append(1) or real(tensors))
    return fetches


def test_steady_state_decode_is_sync_free(model, monkeypatch):
    """Mid-generation ``step_many`` windows make no device->host fetch;
    fetches happen only at completion."""
    cfg, params = model
    eng = ServingEngine(cfg, params, batch_size=2, max_seq=96, device="cpu")
    for i in range(2):
        eng.submit(Request(rid=i, prompt=_prompt(10, seed=i),
                           max_new_tokens=60))
    eng.step()                  # admit + first token: prefill boundary
    assert all(eng.fed_tokens(s) >= eng._plen[s] for s in range(2))

    fetches = _count_fetches(eng, monkeypatch)
    syncs0 = eng.host_syncs
    emitted = 0
    for _ in range(6):          # 48 decode steps, nobody completes
        emitted += eng.step_many(8)["emitted"]
    assert emitted == 96
    assert fetches == [], "steady-state decode touched the host"
    assert eng.host_syncs == syncs0
    monkeypatch.undo()

    eng.run_until_idle()        # completion boundary: one poll happens
    assert eng.host_syncs > syncs0
    for req in eng.pop_completed():
        assert len(req.out_tokens) == 60


def test_host_projection_matches_device(model):
    """The host's progress projection (backlog and completion detection
    without syncing) equals the device's ``fed``."""
    cfg, params = model
    eng = ServingEngine(cfg, params, batch_size=2, max_seq=96, device="cpu")
    eng.submit(Request(rid=0, prompt=_prompt(20, seed=3),
                       max_new_tokens=30))
    eng.submit(Request(rid=1, prompt=_prompt(4, seed=4),
                       max_new_tokens=10))
    for _ in range(4):
        eng.step_many(5)
        dev_fed = eng.sample.fed.tolist()
        for slot, req in enumerate(eng._slots):
            if req is not None:
                assert eng.fed_tokens(slot) == dev_fed[slot]


# ---------------------------------------------------------- load signals
def test_backlog_discounts_prefill_tokens(models):
    """Prefill tokens are discounted in the backlog, decode-heavy work is
    not, and a streamed engine does not discount at all; the reference
    engine reads the same backlogs for the same requests."""
    cfg, params = models["torch"]
    jcfg, jparams = models["jax"]
    eng = ServingEngine(cfg, params, batch_size=2, max_seq=96, device="cpu")
    jeng = JEngine(jcfg, jparams, batch_size=2, max_seq=96)
    long_prompt = Request(rid=0, prompt=_prompt(60, seed=1),
                          max_new_tokens=4)
    eng.submit(long_prompt)
    jeng.submit(JRequest(rid=0, prompt=_prompt(60, seed=1),
                         max_new_tokens=4))
    assert eng.backlog_tokens() < long_prompt.total_tokens
    assert eng.backlog_tokens() == pytest.approx(
        request_cost(long_prompt, eng.prefill_discount))
    assert eng.backlog_tokens() == jeng.backlog_tokens()
    decode_heavy = Request(rid=1, prompt=_prompt(2, seed=2),
                           max_new_tokens=40)
    assert request_cost(decode_heavy) > 40
    streamed = ServingEngine(cfg, params, batch_size=2, max_seq=96,
                             prefill_mode="streamed", device="cpu")
    assert streamed.prefill_discount == 1.0
    streamed.submit(Request(rid=2, prompt=_prompt(60, seed=1),
                            max_new_tokens=4))
    assert streamed.backlog_tokens() == pytest.approx(60 - 1 + 4)


def test_bucket_selection(model):
    cfg, params = model
    eng = ServingEngine(cfg, params, batch_size=2, max_seq=96, device="cpu")
    assert eng._buckets == (16, 64)     # 256 exceeds the cache
    assert eng._pick_chunk(0) == (0, 0)
    assert eng._pick_chunk(7) == (16, 7)       # padded up
    assert eng._pick_chunk(16) == (16, 16)
    assert eng._pick_chunk(40) == (64, 40)     # padded up
    assert eng._pick_chunk(80) == (64, 64)     # largest bucket + tail
    ssm = get_config("mamba2-780m").reduced()
    es = ServingEngine(ssm, zoo.init_serving_params(ssm, device="cpu"),
                       batch_size=2, max_seq=96, device="cpu")
    assert es._pick_chunk(7) == (0, 0)         # no pads: stream short
    assert es._pick_chunk(40) == (16, 16)      # largest fully-real bucket
    assert es._pick_chunk(70) == (64, 64)


# ------------------------------------------------------------- EOS exit
def _eos_runs(models, mode, prompts, max_new, eos=None):
    """Each package's engine over ``prompts`` (one request a prompt, all
    submitted at once): streams, run stats and host syncs."""
    kw = PAGED if mode == "paged" else {}
    out = {}
    for pkg, (E, R, dev) in {"torch": (ServingEngine, Request,
                                       {"device": "cpu"}),
                             "jax": (JEngine, JRequest, {})}.items():
        cfg, params = models[pkg]
        eng = E(cfg, params, batch_size=2, max_seq=96, eos_token=eos,
                **kw, **dev)
        reqs = [R(rid=i, prompt=p.copy(), max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        stats = eng.run_until_idle()
        assert all(r.done for r in reqs)
        out[pkg] = ([list(r.out_tokens) for r in reqs], stats["steps"],
                    stats["tokens"], eng.host_syncs)
    return out


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_eos_early_exit_fewer_steps_identical_tokens(models, mode):
    """Device-side EOS early exit: the engine finishes in FEWER fused
    steps, and the stream is the non-early-exit run's cut at the first
    EOS, inclusive; streams, steps and syncs are the reference's."""
    prompt = [_prompt(10, seed=21)]
    base = _eos_runs(models, mode, prompt, 48)
    (full,), base_steps, _, _ = base["torch"]
    assert len(full) == 48
    eos = full[len(full) // 2]          # a token the model emits mid-stream
    cut = full.index(eos) + 1
    early = _eos_runs(models, mode, prompt, 48, eos=eos)
    (got,), steps, _, _ = early["torch"]
    assert got == full[:cut]
    assert steps < base_steps
    assert base["torch"] == base["jax"]
    assert early["torch"] == early["jax"]


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_eos_early_exit_batch_slots_independent(models, mode):
    """One slot EOS-exits early; its batchmate decodes on unchanged (the
    device mask clear never leaks across slots); both as the
    reference's."""
    prompts = [_prompt(8, seed=22), _prompt(8, seed=23)]
    base = _eos_runs(models, mode, prompts, 30)
    (a, b), _, _, _ = base["torch"]
    eos = a[8]                          # a token slot 0 hits early
    assert eos not in b[:8]
    early = _eos_runs(models, mode, prompts, 30, eos=eos)
    a2, b2 = early["torch"][0]
    assert a2 == a[:a.index(eos) + 1]
    assert b2 == b[:b.index(eos) + 1 if eos in b else len(b)]
    assert base["torch"] == base["jax"]
    assert early["torch"] == early["jax"]


# ------------------------------------------------------------ end to end
def test_serving_engine_end_to_end():
    """``test_system.py``'s engine run: three requests, all done, 12
    tokens (the port's own seeded draw, bf16)."""
    cfg = get_config("granite-8b").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, params, batch_size=2, max_seq=32, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 200, 4, dtype=np.int32),
                    max_new_tokens=4) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run_until_idle()
    assert all(r.done for r in reqs)
    assert all(len(r.out_tokens) == 4 for r in reqs)
    assert stats["tokens"] == 12
