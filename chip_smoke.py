#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold it to account.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. environment: the card's name and power limit, torch and CUDA versions,
   TF32 off for matmuls and cuDNN (set by ``repro_torch.device``);
2. build: every CUDA source of the port with ``nvcc`` for sm_90a, one
   ``nvcc`` per source, all started together;
3. paged-attention kernel vs plain version at granite-8b decode shapes
   (H=32, KV=8, D=128, bs=16, B=8, bf16), on permuted pool rows,
   sentinel table entries and garbage in unreferenced blocks, in bf16 and
   in float32, with times for the kernel, the plain version, one library
   call (gather + ``scaled_dot_product_attention``, a yardstick the port
   never calls) and the HBM bound; then the same at zamba2-2.7b's shared
   attention (H=KV=32, D=80);
4. SSD intra-chunk kernel vs plain version in float32 at the prefill
   chunks of mamba2-780m (h=48, p=64, n=128) and zamba2-2.7b (h=80,
   p=64, n=64), l in {16, 64, 256}, with kernel, plain and bound times
   (no single PyTorch call computes this function: no library time);
5. the main paths, each with every launch count set to 0 just before it
   and read just after: ``ServingEngine(cache_mode="paged")`` at full
   width and depth (random bf16 weights from a seed) serving 8 requests
   of 40-700 prompt tokens and 32 new tokens each, for granite-8b (the
   paged kernel launched 36 x the decode steps), mamba2-780m (the SSD
   kernel 48 x the chunk prefills) and zamba2-2.7b (SSD 54 x the chunk
   prefills, paged 9 x the decode steps); after each, a steady 8-step
   decode window under ``torch.cuda.set_sync_debug_mode("error")`` with
   zero host syncs;
6. kernels vs plain versions on one state at full width and depth, in
   bf16 (the main path) and float32: for granite-8b one paged serve step;
   for mamba2-780m and zamba2-2.7b one 256-token paged chunk prefill plus
   one serve step; logits (and the recurrent state) within a stated
   tolerance;
7. reduced granite-8b, mamba2-780m and zamba2-2.7b in float32: the dense
   and paged engines on the card give the same greedy streams.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor peak
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)   # 2 bf16 ulps at |x| ~ 1-2
F32_TOL = dict(rtol=2e-5, atol=2e-5)        # order of summation only
# SSD kernel vs plain, float32: sums of up to l * n products in another
# order, held to 1e-5 of the largest output and 1e-4 relative.
SSD_RTOL, SSD_ATOL_OF_MAX = 1e-4, 1e-5
# One full-depth serve step, kernel vs plain, on the same state: relative
# L2 of the logits, and the share of lanes whose greedy token agrees.
# bf16: the plain version rounds the softmax weights to bf16 before p.v
# (as the reference does) and the kernel keeps them in float32, so each
# attention output differs by about one bf16 ulp, and 36 layers of random
# weights amplify that (0.041 was seen on an H100); random logits have
# near ties, so the greedy token is not held in bf16.  float32: the two
# differ only in the order of summation (~1e-7 per attention output).
BF16_STEP_TOL = dict(rel_l2=0.1, argmax_agree=0.0)
F32_STEP_TOL = dict(rel_l2=1e-4, argmax_agree=1.0)
# One full-depth 256-token chunk prefill plus one serve step of
# mamba2-780m / zamba2-2.7b, kernels vs plain versions: relative L2 of
# the logits and of the final SSD state of every layer.  float32: the SSD
# cores differ in summation order only (~1e-7 relative per output), as
# does zamba2's paged attention.  bf16: the SSD core is float32 in both,
# but its output is cast to bf16, and an output near a rounding boundary
# lands on the other neighbour; 48-54 layers of random weights amplify
# such one-ulp differences, as the attention's do in granite-8b.
BF16_PREFILL_TOL = dict(rel_l2=0.1, state_rel_l2=0.1, argmax_agree=0.0)
F32_PREFILL_TOL = dict(rel_l2=1e-4, state_rel_l2=1e-4, argmax_agree=1.0)
# The main paths: (arch, attention layers per decode step, Mamba2 layers
# per chunk prefill).
PATHS = (("granite-8b", 36, 0), ("mamba2-780m", 0, 48),
         ("zamba2-2.7b", 9, 54))
PROMPT_LENS = [40, 63, 100, 200, 267, 450, 600, 700]


def log(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each timed with
    CUDA events; ``flush`` (run untimed before each call) evicts L2.

    The device first spins for ~50 ms so that the host enqueues every
    call before the first one runs: the events then bracket device work
    only, not the host's Python between two launches."""
    import torch
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    for s, e in zip(starts, ends):
        if flush is not None:
            flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def assert_close(a, b, tol, what):
    import torch
    ok = torch.allclose(a.float(), b.float(), **tol)
    log(f"  {what}: max_abs_err={max_err(a, b):.3e} tol={tol} ok={ok}")
    if not ok:
        raise AssertionError(f"{what} outside tolerance {tol}")


def paged_kernel_phase(dev, flush, H, KV, D):
    """Paged-attention kernel vs plain at decode shapes (B=8, bs=16, 64
    table columns, pool of 512 blocks); returns the measured numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                         paged_attention_ref)
    # the main path's geometry: 8 lanes, max_seq 1024, pool of 8 x 64
    B, bs, mb, NB = 8, 16, 64, 512
    kv_len_host = [1, 16, 33, 250, 267, 640, 997, 1000]   # 1, boundary, ragged
    g = torch.Generator(dev).manual_seed(1)
    q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
    k_pool = torch.full((NB, bs, KV, D), 1e4, device=dev)   # garbage rows
    v_pool = torch.full((NB, bs, KV, D), -1e4, device=dev)
    perm = torch.randperm(NB, generator=g, device=dev).cpu().tolist()
    bt = torch.full((B, mb), NB, dtype=torch.int32)          # sentinels
    used = 0
    for b, n in enumerate(kv_len_host):
        rows = perm[used:used + -(-n // bs)]
        used += len(rows)
        bt[b, :len(rows)] = torch.tensor(rows, dtype=torch.int32)
        for r in rows:
            k_pool[r] = torch.randn(bs, KV, D, generator=g, device=dev)
            v_pool[r] = torch.randn(bs, KV, D, generator=g, device=dev)
    k_pool, v_pool = k_pool.bfloat16(), v_pool.bfloat16()
    bt = bt.to(dev)
    kv_len = torch.tensor(kv_len_host, dtype=torch.int32, device=dev)
    args = (q, k_pool, v_pool, bt, kv_len)

    out = kernel.paged_attention(*args)
    torch.cuda.synchronize()
    ref = paged_attention_ref(*args)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert_close(out, ref, BF16_TOL, f"D={D} bf16 kernel vs plain")
    err = max_err(out, ref)
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    assert_close(kernel.paged_attention(*f32), paged_attention_ref(*f32),
                 F32_TOL, f"D={D} f32 kernel vs plain")

    # the library yardstick: gather + SDPA (never called by the port)
    G = H // KV
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)

    def library():
        k = gather_pages(k_pool, bt).transpose(1, 2)     # (B, KV, S, D)
        v = gather_pages(v_pool, bt).transpose(1, 2)
        if not gqa:
            k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
        mask = (torch.arange(mb * bs, device=dev)[None, :]
                < kv_len[:, None])[:, None, None, :]
        extra = {"enable_gqa": True} if gqa else {}
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k, v, attn_mask=mask, **extra)[:, :, 0]
    assert_close(library(), ref, BF16_TOL, f"D={D} library vs plain")

    ms = cuda_ms(lambda: kernel.paged_attention(*args), 50, flush)
    plain_ms = cuda_ms(lambda: paged_attention_ref(*args), 20, flush)
    library_ms = cuda_ms(library, 20, flush)
    tokens = sum(kv_len_host)
    bytes_moved = (tokens * KV * D * 2 * 2            # k and v rows, bf16
                   + 2 * B * H * D * 2                # q in, out
                   + sum(-(-n // bs) for n in kv_len_host) * 4 + B * 4)
    flops = 4 * tokens * H * D                        # q.k and p.v
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    log(f"  D={D} times (L2 flushed): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bytes_moved} B, {flops} flop)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if bytes_moved / HBM_BYTES_PER_S
                         >= flops / BF16_FLOPS else "operations"),
            "library_ms": library_ms}


def ssd_bound(l, h, p, n):
    """(flops, bytes, bound ms) of one intra-chunk call (b = nc = 1): the
    causal half of C.B^T once (B and C are shared by the heads), per head
    the causal half of att @ xdt and the (p, n) state product, 2
    operations per multiply-add; each input read and output written once
    in float32."""
    tri = l * (l + 1) // 2
    flops = 2 * (tri * n + h * tri * p + h * l * p * n)
    bytes_moved = 4 * (2 * l * h * p + 2 * l * h + 2 * l * n + h * p * n)
    ms = max(flops / F32_FLOPS, bytes_moved / HBM_BYTES_PER_S) * 1e3
    return flops, bytes_moved, ms


def ssd_kernel_phase(dev, flush):
    """SSD kernel vs plain (float32) at the full models' prefill chunks;
    returns the record of mamba2-780m's 256-token chunk with every shape
    measured beside it."""
    import torch
    from repro_torch.kernels.ssd import kernel, ssd_intra_chunk_ref
    rows = []
    g = torch.Generator(dev).manual_seed(2)
    for model, (h, p, n) in (("mamba2-780m", (48, 64, 128)),
                             ("zamba2-2.7b", (80, 64, 64))):
        for l in (16, 64, 256):
            def randn(*shape):
                return torch.randn(shape, generator=g, device=dev)
            xr = randn(1, 1, l, h, p)
            dtr = torch.nn.functional.softplus(randn(1, 1, l, h))
            dA_cs = torch.cumsum(-randn(1, 1, l, h).abs() * 0.1, dim=2)
            args = (xr, dtr, dA_cs, randn(1, 1, l, n), randn(1, 1, l, n))
            y, st = kernel.ssd_intra_chunk(*args)
            torch.cuda.synchronize()
            y_ref, st_ref = ssd_intra_chunk_ref(*args)
            assert torch.isfinite(y).all() and torch.isfinite(st).all()
            err = 0.0
            for what, a, b in (("y", y, y_ref), ("state", st, st_ref)):
                tol = dict(rtol=SSD_RTOL,
                           atol=SSD_ATOL_OF_MAX * float(b.abs().max()))
                assert_close(a, b, tol, f"{model} l={l} {what} kernel vs "
                             f"plain")
                err = max(err, max_err(a, b))
            ms = cuda_ms(lambda: kernel.ssd_intra_chunk(*args), 50, flush)
            # the same calls with the inputs left in L2: how much of the
            # time is a cold start rather than the work
            warm_ms = cuda_ms(lambda: kernel.ssd_intra_chunk(*args), 50)
            plain_ms = cuda_ms(lambda: ssd_intra_chunk_ref(*args), 20,
                               flush)
            flops, nbytes, bound_ms = ssd_bound(l, h, p, n)
            bound_by = ("operations" if flops / F32_FLOPS
                        >= nbytes / HBM_BYTES_PER_S else "bytes")
            log(f"  {model} l={l} (h={h} p={p} n={n}): kernel {ms:.4f} ms "
                f"({warm_ms:.4f} ms with warm L2), plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.5f} ms ({bound_by}: {flops} flop, "
                f"{nbytes} B)")
            rows.append({"model": model, "l": l, "h": h, "p": p, "n": n,
                         "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "flops": flops, "bytes": nbytes,
                         "max_abs_err": err})
    main = next(r for r in rows
                if r["model"] == "mamba2-780m" and r["l"] == 256)
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:54",
            "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "at_shapes": rows}


def requests(cfg, lens, max_new, seed, start=0):
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=start + i, prompt=rng.integers(
                0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=max_new) for i, n in enumerate(lens)]


def serve_path(arch, attn_layers, mamba_layers, dev):
    """One main path: a paged engine at full width and depth serves 8
    requests, every launch count set to 0 just before and read just
    after; then a steady window with zero host syncs.  Returns (engine,
    params, launches by kernel)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = zoo.init_serving_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"[engine] {arch} {cfg.num_layers} layers d={cfg.d_model} "
        f"params={zoo.num_params(cfg)} drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(cfg, params, batch_size=8, max_seq=1024,
                           block_size=16, cache_mode="paged", device=dev)
    reqs = requests(cfg, PROMPT_LENS, 32, seed=0)
    for r in reqs:
        engine.submit(r)
    pa.launches = ssd.launches = 0
    stats = engine.run_until_idle()
    torch.cuda.synchronize()
    launches = {"paged_attention": pa.launches,
                "ssd_intra_chunk": ssd.launches}
    for r in reqs:
        assert r.done and len(r.out_tokens) == 32, (r.rid, r.out_tokens)
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
    want = {"paged_attention": attn_layers * stats["steps"],
            "ssd_intra_chunk": mamba_layers * engine.chunk_prefills}
    assert launches == want, (launches, want)
    log(f"  served {len(reqs)}/{len(reqs)}: {stats['tokens']} tokens, "
        f"{stats['steps']} decode steps, {stats['seconds']:.2f} s "
        f"({stats['tok_per_s']:.1f} tok/s incl. prefill), launches "
        f"{launches} = {attn_layers} x {stats['steps']} steps, "
        f"{mamba_layers} x {engine.chunk_prefills} chunk prefills; "
        f"host_syncs {engine.host_syncs}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    steady = requests(cfg, [20] * 8, 64, seed=1, start=100)
    for r in steady:
        engine.submit(r)
    engine.step_many(8)                 # admit (prefill) + first window
    syncs = engine.host_syncs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        window = engine.step_many(8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert window["steps"] == 8 and engine.host_syncs == syncs
    log(f"[steady] {arch}: 8 fused steps x 8 lanes under "
        f"sync_debug_mode=error: 0 host syncs, {dt * 1e3 / 8:.2f} ms/step, "
        f"{window['emitted'] / dt:.1f} decode tok/s")
    return engine, params, launches, steady


def step_vs_plain(cfg, params, shape, pool_blocks, saved, tol):
    """One paged serve step with the kernel and with the plain version,
    each on its own copy of ``saved = (state, next_tok, active)``."""
    import torch
    from repro_torch.models import model_zoo as zoo
    state, next_tok, active = saved
    outs = {}
    for impl in ("kernel", "ref"):
        step = zoo.make_paged_serve_step(cfg, shape, state.cache["k"].shape[2],
                                         pool_blocks, impl=impl)
        logits, _ = step(params, copy.deepcopy(state), next_tok.clone(),
                         active.clone())
        outs[impl] = logits[:, -1, :cfg.vocab_size].float()
    torch.cuda.synchronize()
    a, b = outs["kernel"], outs["ref"]
    assert torch.isfinite(a).all() and a.shape == b.shape
    rel = rel_l2(a, b)
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"[step {cfg.compute_dtype}] kernel vs plain logits at full depth: "
        f"rel_l2={rel:.3e} max_abs={max_err(a, b):.3e} argmax agreement "
        f"{agree:.3f} (tol {tol})")
    assert rel <= tol["rel_l2"] and agree >= tol["argmax_agree"]


def prefill_step_vs_plain(cfg, params, dev, tol):
    """A 256-token paged chunk prefill into lane 0 plus one serve step,
    with the kernels and with ``impl="ref"``, from one fresh state each:
    lane 0's logits and the SSD state of every layer."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model_zoo as zoo
    shape, bs, nb = ShapeConfig("serve", 1024, 8, "decode"), 16, 512
    g = torch.Generator(dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, 257), generator=g,
                         device=dev, dtype=torch.int32)
    lane = 1 if cfg.family == "ssm" else 2      # lane axis of "ssm"
    outs = {}
    for impl in ("kernel", "ref"):
        state = zoo.init_paged_decode_state(cfg, shape, bs, nb, dev)
        state.block_tables[0, :17] = torch.arange(17, dtype=torch.int32,
                                                  device=dev)
        prefill = zoo.make_paged_bulk_prefill(cfg, shape, 256, bs, nb,
                                              first_chunk=True, impl=impl)
        state = prefill(params, state, toks[:, :256], 0, 0, 256)
        step = zoo.make_paged_serve_step(cfg, shape, bs, nb, impl=impl)
        tok = torch.zeros((8, 1), dtype=torch.int32, device=dev)
        tok[0] = toks[0, 256]
        active = torch.zeros(8, dtype=torch.int32, device=dev)
        active[0] = 1
        logits, state = step(params, state, tok, active)
        outs[impl] = (logits[0, -1, :cfg.vocab_size].float(),
                      state.cache["ssm"].select(lane, 0).clone())
        del state
    torch.cuda.synchronize()
    (a, sa), (b, sb) = outs["kernel"], outs["ref"]
    assert torch.isfinite(a).all() and torch.isfinite(sa).all()
    rel, srel = rel_l2(a, b), rel_l2(sa, sb)
    agree = float(a.argmax() == b.argmax())
    log(f"[prefill+step {cfg.name} {cfg.compute_dtype}] kernels vs plain at "
        f"full depth: logits rel_l2={rel:.3e} max_abs={max_err(a, b):.3e}, "
        f"SSD state rel_l2={srel:.3e}, argmax agreement {agree:.0f} "
        f"(tol {tol})")
    assert rel <= tol["rel_l2"] and srel <= tol["state_rel_l2"]
    assert agree >= tol["argmax_agree"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serving.engine import ServingEngine

    t_start = time.perf_counter()
    # 1. environment
    dev = resolve_device("cuda")
    card = gpu_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    # 2. build
    t0 = time.perf_counter()
    paths = build.compile_all()
    log(f"[build] {sorted(paths)} in {time.perf_counter() - t0:.2f} s")
    for name, info in build.build_log.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_      # 256 MB > 50 MB L2: each call starts cold

    # 3. paged attention vs plain: granite-8b, then zamba2-2.7b (D = 80)
    log("[kernel] paged_attention vs plain at granite-8b shapes")
    paged = {"name": "paged_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention/kernel.py:73",
             "launches": None,
             **paged_kernel_phase(dev, flush, H=32, KV=8, D=128)}
    log("[kernel] paged_attention vs plain at zamba2-2.7b shapes (D=80)")
    paged["at_d80"] = paged_kernel_phase(dev, flush, H=32, KV=32, D=80)

    # 4. SSD intra-chunk vs plain
    log("[kernel] ssd_intra_chunk vs plain at full prefill-chunk shapes")
    ssd = ssd_kernel_phase(dev, flush)
    del flush_buf
    torch.cuda.empty_cache()

    # 5-6. the main paths, then kernels vs plain at full width and depth
    by_path = {}
    for arch, attn_layers, mamba_layers in PATHS:
        engine, params, launches, steady = serve_path(
            arch, attn_layers, mamba_layers, dev)
        by_path[arch] = launches
        cfg = engine.cfg
        if cfg.family == "dense":
            shape, pool_blocks = engine.shape, engine.pool_blocks
            saved = (copy.deepcopy(engine.state),
                     engine.sample.next_tok.clone(),
                     engine.sample.active.clone())
            step_vs_plain(cfg, params, shape, pool_blocks, saved,
                          BF16_STEP_TOL)
        else:
            prefill_step_vs_plain(cfg, params, dev, BF16_PREFILL_TOL)
        engine.run_until_idle()
        assert all(r.done and len(r.out_tokens) == 64 for r in steady)
        del engine, params
        torch.cuda.empty_cache()
        cfg32 = cfg.with_(compute_dtype="float32")
        params32 = zoo.init_serving_params(cfg32, seed=0, device=dev)
        if cfg.family == "dense":
            step_vs_plain(cfg32, params32, shape, pool_blocks, saved,
                          F32_STEP_TOL)
            del saved
        else:
            prefill_step_vs_plain(cfg32, params32, dev, F32_PREFILL_TOL)
        del params32
        torch.cuda.empty_cache()
    for record, key in ((paged, "paged_attention"), (ssd, "ssd_intra_chunk")):
        record["launches_by_path"] = {a: c[key] for a, c in by_path.items()
                                      if c[key]}
        record["launches"] = sum(record["launches_by_path"].values())

    # 7. small float32 parity on the card: dense vs paged engine
    for arch, _, _ in PATHS:
        small = get_config(arch).reduced().with_(compute_dtype="float32")
        sp = zoo.init_serving_params(small, seed=0, device=dev)
        streams = []
        for mode in ("dense", "paged"):
            eng = ServingEngine(small, sp, batch_size=3, max_seq=96,
                                prefill_buckets=(16, 64), cache_mode=mode,
                                block_size=8, device=dev)
            rs = requests(small, [5, 20, 70, 90, 12, 40], 6, seed=11)
            for r in rs:
                eng.submit(r)
            eng.run_until_idle()
            assert all(r.done for r in rs)
            streams.append([r.out_tokens for r in rs])
        assert streams[0] == streams[1], streams
        log(f"[small] reduced {arch} f32: dense and paged (kernel) engines "
            f"give identical greedy streams")

    log(f"[total] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": [paged, ssd]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
