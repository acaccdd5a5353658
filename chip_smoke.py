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
   (H=32, KV=8, D=128, bs=16, bf16), for three lane mixes (the skewed
   B=8 one, 8 lanes of 500 positions, one lane of 1000), on permuted pool
   rows, sentinel table entries and garbage in unreferenced blocks, in
   bf16 (each output to one bf16 ulp of itself plus 2^-7 of its row's
   RMS, the whole to 2e-3 relative L2 at the skewed mix; and against the
   plain version with p unrounded, each output to one ulp, the whole to
   1e-3) and in float32, with times for the kernel (L2 flushed and
   warm), the plain version, one library call (gather +
   ``scaled_dot_product_attention``, a yardstick the port never calls)
   and the HBM bound; then the same at zamba2-2.7b's shared attention
   (H=KV=32, D=80) and at qwen2-moe-a2.7b's (H=KV=16, D=128: a GQA group
   of 1, one query row of the 16 the tensor-core tile holds); an empty
   launch through the same ctypes path; three
   calls back to back that change geometry and lengths, each held to its
   limits, the kernel's counters back to zero after them; then the
   kernel as built: ``ptxas`` registers and spills of every
   instantiation (none may spill) and the tensor-core instructions
   (``HMMA``) in the SASS of the bf16 ones, which must hold some;
4. SSD intra-chunk kernel vs plain version in float32 at the prefill
   chunks of mamba2-780m (h=48, p=64, n=128) and zamba2-2.7b (h=80,
   p=64, n=64), l in {16, 64, 256}, and at zamba2-2.7b's 16384-token
   prefill (b * nc = 64, l = 256), with kernel (L2 flushed and warm),
   plain and bound times beside an empty kernel launched through the same
   ctypes path (no single PyTorch call computes this function: no library
   time); TFLOP/s and the shares of the 3xTF32 and FFMA bounds are
   logged; then the kernel as built: ``ptxas`` registers and spills and
   the tensor-core instructions (``HMMA``) in the SASS of every
   instantiation, which must hold some and spill nothing;
5. the main paths, each with every launch count set to 0 just before it
   and read just after: ``ServingEngine(cache_mode="paged")`` at full
   width and depth (random bf16 weights from a seed) serving 8 requests
   of 40-700 prompt tokens and 32 new tokens each, for granite-8b (the
   paged kernel launched 36 x the decode steps), mamba2-780m (the SSD
   kernel 48 x the chunk prefills), zamba2-2.7b (SSD 54 x the chunk
   prefills, paged 9 x the decode steps) and qwen2-moe-a2.7b (moe: 60
   routed experts, top-4, 4 shared; paged 24 x the decode steps; 28.6 GB
   of weights, the peak of their drawing logged), the SSD launches
   counted by
   chunk length and an estimate of the kernel's ms per Mamba2 layer over
   that mix, priced from phase 4's times; after each, a steady 8-step
   decode window under ``torch.cuda.set_sync_debug_mode("error")`` with
   zero host syncs; for qwen2-moe-a2.7b the device ms of one
   ``moe_block`` at decode (8 lanes) and at one 256-token chunk beside
   its bound (the block's weight bytes, every expert, over the HBM rate);
6. kernels vs plain versions on one state at full width and depth, in
   bf16 (the main path) and float32: for granite-8b and qwen2-moe-a2.7b
   one paged serve step (qwen2-moe in float32: 57 GB of weights, drawn
   after the bf16 ones are freed);
   for mamba2-780m and zamba2-2.7b one 256-token paged chunk prefill plus
   one serve step; logits (and the recurrent state) within a stated
   tolerance;
7. reduced granite-8b, mamba2-780m, zamba2-2.7b and qwen2-moe-a2.7b in
   float32: the dense and paged engines on the card give the same greedy
   streams, and a second paged run gives them again bit for bit;
8. the tile runtime at full size (16384^2 float32, 4 PEs x 4 tiles),
   fresh, in a process that has not loaded the Jacobi kernel yet: its
   first step's per-PE device times against their medians over a steady
   window of 400 steps, one host sync each (any other sync an error),
   with the window's wall and device-busy time per step and their
   spread; then the LULESH proxy's first timed step (its first run at a
   tile count is kept out of the timing) against its next 5;
9. Jacobi stencil kernel vs plain version, bit for bit, at the 5 shapes of
   ``tests/test_kernels.py`` in float32 and bf16 and at 16384^2 and
   32768^2 in float32, with kernel, plain, library (``F.conv2d`` of the
   grid padded outside the timing, with the 5-point cross weights) and
   HBM-bound times at both full grids; then the tile form at full size
   after a load balance moved tiles, one PE's launch against its plain
   version;
10. the stencil app at full size (16384^2 float32, 4 PEs), its launch count
   set to 0 just before each run and read just after: ``run_jacobi`` with
   500 us message latency at odf 1, 4 and 8 (C1), then ``run_lulesh``
   on rates [1, 0.9, 0.4, 1] without and with rate-aware GreedyRefine
   every 6 steps (C2); times per iteration, accounted and exposed times,
   the LB improvement, migrations and peak memory are printed, not
   asserted;
11. the app's correctness on the card, asserted: 6 tiled steps equal
   ``reference_jacobi`` (plain) and 6 global kernel sweeps bit for bit; a
   run whose tiles the balancer (and then a hand-set assignment) moved
   equals an unmoved one; a 4 -> 2 PE checkpoint/restore continues
   bit-identically; launches = PEs holding tiles per step; one host sync
   per step;
12. ``TileRuntimeDriver`` on the ``EventLoop`` with a ``FaultTrace``, at
   full size: a checkpoint at the notice, a rebalance at the
   recommendation;
13. flash-attention kernel vs plain version (``flash_attention_ref``) at
   the 5 shapes of ``tests/test_kernels.py``, causal and not, in float32
   and bf16 (bf16 to one bf16 ulp, and against ``flash_ref`` at the
   reference's 3e-2);
   then at granite-8b's prefill shape (S=16384, H=32, KV=8, D=128) and
   zamba2-2.7b's (H=KV=32, D=80), bf16, causal, read through the
   (B, S, H, D) layout the model gives it, with kernel, plain, library
   (``scaled_dot_product_attention`` on KV repeated outside the timing, a
   yardstick the port never calls) and bound times; at the full shapes
   each bf16 output is held to one bf16 ulp of itself (``FLASH_FULL_TOL``)
   and the whole to 1e-3 relative L2; TFLOP/s, the shares of the bound
   and of the split-p floor and the ratio to SDPA are logged; then the
   kernel as built: ``ptxas`` registers and spills of every flash
   instantiation, and the tensor-core instructions (``HGMMA``) in the
   SASS of the bf16 D = 128 and D = 80 ones, which must hold some and
   spill nothing;
14. the long-prompt path, its flash launch count set to 0 just before and
   read just after: ``ServingEngine(cache_mode="dense")`` on full-width
   granite-8b (random bf16 weights from seed 0, max_seq 16640, buckets
   up to 16384) serves prompts of 9000, 12500, 16000, 40 and 200 tokens,
   16 new tokens each; flash launches = 36 x the bulk prefills at the
   16384 bucket; then one 16384-token bulk prefill's wall time, and under
   the profiler its device-busy share and the flash and SSD kernels'
   shares of it; then
   the hybrid route, likewise counted and timed: a dense engine on
   full-width zamba2-2.7b bulk-prefills 16384 tokens of a 16400-token
   prompt (its shared attention, head_dim 80: flash launches = 9, SSD
   launches = 54 x its 2 bulk prefills) beside a 40-token one;
15. kernel vs plain at full depth: one 16384-token ``make_prefill`` of
   granite-8b and of zamba2-2.7b with ``impl="kernel"`` and
   ``impl="ref"`` from the same tokens, last-position logits in bf16 and
   float32 within a stated tolerance;
16. reduced granite-8b in float32 with a bucket of 8704: the dense engine
   (flash kernel) and the paged engine give the same greedy streams for
   a prompt of 8300 tokens and two short ones;
17. work-unit migration on the card, after phase 7, for granite-8b,
   zamba2-2.7b and qwen2-moe-a2.7b at full width and depth (phase 5's
   engine and requests):
   run A serves them unmigrated; run B, two decode windows in, packs 3
   slots into a second engine, preempts 2 and resumes them in place,
   checkpoints the rest and replays the checkpoint in a third engine;
   every stream equals run A's token for token, the window after each
   unpack and resume runs under ``set_sync_debug_mode("error")`` with no
   host sync, and the launch counts (zeroed just before run B) are the
   layers times the decode steps (and chunk prefills) of the three
   engines; the packed units install into a fresh engine and pack again
   bit for bit (bytes, install and pack ms per unit).  qwen2-moe-a2.7b
   then packs all 8 slots two windows in and unpacks them into a fresh
   engine, whose streams equal run A's (bytes, pack and install ms per
   unit).  granite-8b then
   packs all 8 slots two windows in (ms per unit beside pinned copies of
   the same bytes), times ``InMemoryStore`` and ``DeviceStore`` save and
   restore of the full decode state, and installs the units into a dense
   engine, a 32-position block engine and an engine resized 8 -> 4 -> 8
   lanes: every column comes back bit for bit, the first step's logits
   agree with the source geometry's within ``MIGRATE_LOGITS_TOL``, and
   whether the streams still equal run A's is logged;
18. the serving cluster on the card: ``ServingCluster`` over a fleet of
   paged full-width granite-8b replicas (one ``params`` shared, random
   bf16 weights from seed 0, 8 lanes, 1024 positions, blocks of 16) of
   speeds 2.0 (an accelerator host: ``DeviceEndpoint``), 2.0, 0.7 and
   0.7 (``HostEndpoint``) serves 24 requests of 40-700 prompt tokens, 32
   new each, through two spot interruptions (r0, r1) that drain slots
   mid-decode; every stream equals a lone paged engine's of the same
   geometry, the paged launches (zeroed just before, read just after)
   are 36 x the decode steps summed over the replicas, and the run
   repeated gives the same journal digest and summary (the wall-clock
   keys left out).  Wall and virtual times, per-replica tokens and host
   syncs, each drain's stage ms and bytes per unit by endpoint kind, the
   install ms by where the columns lay and peak memory are logged.  One
   unit staged through each endpoint kind installs into a decoding
   engine in a window with no host sync.  Then a seeded chaos soup with
   one hard kill of its own, survived through checkpoints, the failure
   detector and the straggler policy (every stream again the lone
   engine's), and ``repro_torch.launch.serve.main`` in cluster mode at
   full width (16 of 16 served), after phase 19;
19. the market and vertical layers on the same ``params``, each run's
   paged launches zeroed just before it and read just after (36 x the
   decode steps summed over the replicas) and its peak memory logged.
   The market A/B: the reference's ``cluster_spot_market`` scenario
   (three std.1x replicas bought on a volatile and a steady market, the
   different_market fallback, 30 classed requests at Poisson 2.0/s) at
   the scenario's 2 lanes and decode block 4, naive once and adjusted
   twice: every stream equals a lone engine's, naive is interrupted and
   every drain moves a slot, adjusted saves more at no lower
   interactive attainment, and the two adjusted runs give the same
   digest and summary; per-market purchases, dollars and interruptions,
   each buy's effective prices and the drains' stage ms are logged.
   The vertical A/B: the reference's ``cluster_vertical`` scenario at 4
   -> 8 lanes (two on-demand replicas, 8 batch requests and a surge of 6
   interactive ones), the horizontal arm against
   ``FixedThresholdVertical`` + ``QoSPolicy``: grows and shrinks through
   the paged engine's ``resize`` (device ms and pool blocks logged), no
   unit lost, evictions BestEffort first, the scenario's attainment at a
   strictly lower fleet cost.  In bf16 the horizontal arm's streams
   equal a 4-lane lone engine's, and a vertical stream may leave them
   only at the token where an 8-lane lone engine does (cuBLAS rounds
   otherwise at another M); then the A/B again in float32 at full width
   (the bf16 weights freed first), where every stream equals the lone
   engine's, and a QoS-keyed shrink of one 8-lane float32 engine from 8
   to 4 lanes evicts its 4 BestEffort units, which resume to the lone
   engine's streams.  Then the launcher at full width in three modes:
   phase 18's drained interruption, ``--market adjusted --fallback
   different_market --scaling cost_aware --slo-mix 0.5 --router
   slo_aware``, and ``--vertical window --qos --slo-mix 0.5`` (16 of 16
   served each, evictions BestEffort first); then qwen2-moe-a2.7b
   through the launcher at full width, one paged engine (8 of 8 served)
   and the drained cluster mode (16 of 16), each with paged launches =
   24 x the decode steps.

Each phase's wall time is logged (``[time]``).  The line before the
last is the ``kernels`` JSON; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor peak
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
TF32X3_FLOPS = 495e12 / 3      # float32 products as 3 TF32 tensor products
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)   # 2 bf16 ulps at |x| ~ 1-2
# The paged kernel vs its plain version, bf16.  The plain version rounds
# the softmax weights p to bf16 before p.v (as the reference does) and the
# kernel keeps them to 2^-16 (two bf16 terms, as the Pallas kernel keeps
# them float32), so an output
# differs by a share of its (lane, head) row's size, whatever its own: at
# most 5.8e-3 of the row's RMS beyond one bf16 ulp of itself, rel. L2
# 1.19e-3 and 1.20e-3 over the phase's outputs (D = 128 and 80, on an
# H100, benchmarks/paged_bf16_readings.py).  Each element is held to one
# ulp of itself plus 2^-7 of its row's RMS, the whole to 2e-3 relative
# L2.  (BF16_TOL's absolute 1.6e-2 was ~40% of an output at the
# 640-1000-position lanes, mean |x| ~ 4e-2.)
PAGED_BF16_TOL = dict(rtol=2.0 ** -7, atol_of_row_rms=2.0 ** -7)
PAGED_BF16_REL_L2 = 2e-3
# The bf16 paged kernel against the plain version in float32 on the same
# inputs, its output rounded to bf16 once: the function the kernel
# computes, p unrounded.  The two differ in the order of summation only
# (~1e-6 relative before the rounding), so an output lands on the other
# bf16 neighbour now and then: one ulp of itself at most (2^-7 of |x|,
# atol 1e-5 for outputs near zero), the whole within 1e-3 relative L2.
PAGED_EXACT_P_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
PAGED_EXACT_P_REL_L2 = 1e-3
# Lane mixes of the paged phase (kv_len per lane): the skewed one (1,
# a page boundary, ragged, up to the table's 1000), 8 equal lanes, and
# one long lane alone.  PAGED_BF16_REL_L2 was set from the skewed mix,
# and holds there only: where every lane is long, the plain version's
# rounding of p moves ~42% of the outputs to the other bf16 neighbour,
# and the earlier kernel (p float32, tiles dealt to a fixed number of
# splits) read 2.48e-3 to 2.60e-3 at the other two mixes on an H100, as
# any kernel that keeps p does.  There the relative
# L2 against the plain version is logged, and the whole output is held
# to PAGED_EXACT_P_REL_L2 against the plain version with p unrounded
# (benchmarks/paged_readings.py).
PAGED_MIXES = {"skewed": (1, 16, 33, 250, 267, 640, 997, 1000),
               "uniform": (500,) * 8, "one long lane": (1000,)}
F32_TOL = dict(rtol=2e-5, atol=2e-5)        # order of summation only
# SSD kernel vs plain, float32: sums of up to l * n products in another
# order, held to 1e-5 of the largest output and 1e-4 relative.
SSD_RTOL, SSD_ATOL_OF_MAX = 1e-4, 1e-5
# The SSD kernel's shapes: (model, b * nc, l, (h, p, n)).  The chunk
# prefills of the main paths (b * nc = 1 at the buckets 16, 64 and 256),
# then zamba2-2.7b's 16384-token prefill (chunk 256: b * nc = 64).
SSD_MODELS = (("mamba2-780m", (48, 64, 128)), ("zamba2-2.7b", (80, 64, 64)))
SSD_SHAPES = tuple((m, 1, l, dims) for m, dims in SSD_MODELS
                   for l in (16, 64, 256)) + (
    ("zamba2-2.7b", 64, 256, (80, 64, 64)),)
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
# the logits and of the final SSD state of every layer.  bf16: the SSD
# core is float32 in both, but its output is cast to bf16, and an output
# near a rounding boundary lands on the other neighbour; 48-54 layers of
# random weights amplify such one-ulp differences, as the attention's do
# in granite-8b.  float32: the SSD cores differ in the order of summation
# (~2e-7 relative per output, as far as the plain version lies from
# float64), and 48-54 random float32 layers amplify that to ~1e-4 at the
# logits, more or less by chance: the plain version lands 1.5e-4
# (zamba2-2.7b) to 2.2e-4 (mamba2-780m) from a run whose SSD core is
# exact (float64), so a kernel-vs-plain limit of 1e-4 would refuse an
# exact core.  Each float32 check runs three token sequences, and each
# sequence four times: kernels, plain, an exact core, and a control core
# in single-pass TF32.  Over the three (root mean square): kernel vs
# plain within 3e-4 (the exact core reads up to 2.2e-4); the kernel at
# most 1.5 times as far from the exact-core run as the plain version;
# the control more than 1.5 times as far (the check refuses it); the
# same greedy token in the kernel, plain and exact runs.
BF16_PREFILL_TOL = dict(rel_l2=0.1, state_rel_l2=0.1, argmax_agree=0.0)
F32_PREFILL_TOL = dict(rel_l2=3e-4, state_rel_l2=3e-4, f64_ratio=1.5,
                       argmax_agree=1.0, seeds=(3, 4, 5))
# The main paths: (arch, attention layers per decode step, Mamba2 layers
# per chunk prefill).
MOE_ARCH, MOE_ATTN_LAYERS = "qwen2-moe-a2.7b", 24
PATHS = (("granite-8b", 36, 0), ("mamba2-780m", 0, 48),
         ("zamba2-2.7b", 9, 54), (MOE_ARCH, MOE_ATTN_LAYERS, 0))
PROMPT_LENS = [40, 63, 100, 200, 267, 450, 600, 700]
# Work-unit migration (phase 17): the main path's 8 requests, two decode
# windows in, then slots packed into a second engine of the same geometry
# and slots preempted and resumed in place.  The paths: (arch, attention
# layers per decode step, Mamba2 layers per chunk prefill).
MIGRATE_PATHS = (("granite-8b", 36, 0), ("zamba2-2.7b", 9, 54),
                 (MOE_ARCH, MOE_ATTN_LAYERS, 0))
MIGRATE_PACK, MIGRATE_PREEMPT = [1, 4, 6], [0, 3]
# The first decode step after an install into another geometry (a dense
# cache, 32-position blocks, 4 lanes after a resize) against the same
# step in the source geometry, on bit-identical caches: the step's own
# arithmetic differs (the dense cache's plain attention against the paged
# kernel, another page walk, cuBLAS at M = 4), and 36 layers of random
# bf16 weights amplify that as in the kernel-vs-plain step
# (BF16_STEP_TOL), so the same limit holds here; argmax agreement logged.
MIGRATE_LOGITS_TOL = BF16_STEP_TOL
# The serving cluster (phase 18): granite-8b replicas with paged caches
# at the main path's geometry, a fleet of (name, speed, accelerator), 24
# requests (the main path's prompt lengths three times, 32 new tokens
# each) at t = 0, and spot interruptions (virtual t, replica) fixed so
# that each drain catches slots mid-decode.  The event timeline follows
# the token counts only, so the reduced model on the CPU gives the same
# one.  The chaos run samples its soup from a fixed seed (its one hard
# kill lands before the first checkpoint, so that replica's requests
# replay from the prompt) and adds a hard kill (virtual t, replica) of
# the accelerator replica after checkpoints, so that its units replay
# from the device endpoint's store.
CLUSTER_ARCH, CLUSTER_ATTN_LAYERS = "granite-8b", 36
CLUSTER_FLEET = (("gpu.2x", 2.0, True), ("spot.2x", 2.0, False),
                 ("spot.0.7x", 0.7, False), ("spot.0.7x", 0.7, False))
CLUSTER_GEOMETRY = dict(batch_size=8, max_seq=1024, decode_block=8)
CLUSTER_LENS = PROMPT_LENS * 3
CLUSTER_INTERRUPTS = ((30.0, 0), (40.0, 1))
CLUSTER_CHAOS = dict(rate=0.05, horizon=200.0, seed=0)
CLUSTER_KILL = (100.0, 0)
CLUSTER_CKPT_S = 30.0      # virtual seconds between recovery checkpoints
# The cluster launcher at full width: the flags every call shares, then
# each call's own (phase 18's drained interruption, phase 19's market and
# vertical modes).
CLUSTER_CLI = ["--cluster", "--no-reduced", "--cache-mode", "paged",
               "--batch-size", "8", "--max-seq", "1024", "--fleet",
               "2x2.0,2x0.7", "--requests", "16"]
LAUNCHES = (
    ("cluster launcher", ["--router", "rate_aware", "--interrupt-at", "4"]),
    ("market launcher", ["--market", "adjusted", "--fallback",
                         "different_market", "--scaling", "cost_aware",
                         "--slo-mix", "0.5", "--router", "slo_aware"]),
    ("vertical launcher", ["--vertical", "window", "--qos", "--slo-mix",
                           "0.5"]))
# The summary keys that hold real (wall-clock) seconds: the stores' stage
# times and the market ledger's sum of the drains' stage times; every
# other key is virtual time (or dollars over it) and must repeat exactly.
CLUSTER_WALL_KEYS = ("preempt_stage_s", "interruption_overhead_s",
                     "recovery_restore_s", "checkpoint_stage_s",
                     "resize_stage_s", "spot_interruption_overhead_s")
# Phase 19, the market A/B: the reference's ``cluster_spot_market``
# scenario (benchmarks/run.py) on paged full-width granite-8b replicas of
# the main path's geometry: three std.1x spot replicas bought on two
# markets (name, base $/h, volatility, spikes, interruptions/h at base,
# price power, seed), the different_market fallback, 30 classed requests
# at Poisson 2.0/s.  The naive shopper buys the volatile market and is
# interrupted in its spike; the adjusted one prices the spike in.
MARKET_MARKETS = (
    ("volatile", 0.25, 0.06, ((10.0, 400.0, 5.0),), 4.0, 3.0, 1),
    ("steady", 0.45, 0.02, (), 0.05, 2.0, 2))
MARKET_REPLICAS, MARKET_REQUESTS, MARKET_RATE = 3, 30, 2.0
# The scenario's own lanes and decode block (2 and the cluster's default
# 4).  At the main path's 8 lanes and decode block 8 (planned with the
# reduced model, whose virtual timeline is the full model's), two of the
# naive run's three drains find no live slot to move and the adjusted
# shopper's interactive attainment falls below naive's (0.571 against
# 0.714), so the A/B would show neither the drains nor the scenario's
# claim.
MARKET_GEOMETRY = dict(CLUSTER_GEOMETRY, batch_size=2, decode_block=4)
MARKET_RUNS = (("naive", "naive"), ("adjusted", "adjusted"),
               ("adjusted again", "adjusted"))
# Phase 19, the vertical A/B: the reference's ``cluster_vertical``
# scenario at 4 -> 8 lanes (its 2 -> 4 doubled): two on-demand std.1x
# replicas, 8 batch-class requests at t = 0 and a surge of 6 interactive
# ones at t = 6; the horizontal arm buys up to two more replicas of 4
# lanes, the vertical arm grows each replica to 8 lanes in place.
VERTICAL_LANES = (4, 8)
VERTICAL_BATCH, VERTICAL_SURGE, VERTICAL_SURGE_T = 8, 6, 6.0
# The Jacobi kernel: tests/test_kernels.py's shapes, then full grids.
JACOBI_SHAPES = [(64, 64), (128, 64), (64, 128), (256, 32), (32, 32)]
JACOBI_FULL = (16384, 32768)
# The stencil app: a 16384^2 float32 grid (1 GiB, 2 GiB double-buffered)
# on 4 PEs, the paper's C1 odf sweep and C2 heterogeneous rates.
STENCIL_N, STENCIL_PES, STENCIL_ODFS = 16384, 4, (1, 4, 8)
C1_ITERS, C2_ITERS, C2_RATES = 20, 24, [1.0, 0.9, 0.4, 1.0]
STEADY_STEPS = 400
# The flash kernel: tests/test_kernels.py's (b, h, kv, s, d, bq, bkv), then
# the full prefill shapes (model, H, KV, D) at LONG_S tokens.
FLASH_SHAPES = [(1, 4, 2, 128, 32, 32, 32), (2, 8, 8, 64, 16, 32, 16),
                (1, 4, 4, 128, 64, 64, 64), (1, 6, 3, 96, 32, 32, 32),
                (1, 2, 1, 64, 16, 16, 32)]
FLASH_FULL = (("granite-8b", 32, 8, 128), ("zamba2-2.7b", 32, 32, 80))
# The flash kernel vs its plain version in bf16, at the test shapes and
# the full ones.  The plain version keeps p in float32 and the kernel to
# 2^-16 of it (two bf16 terms); both round each output to bf16 once, so
# they differ only where their float32 values (another order of sums, p
# to 2^-16) straddle a rounding boundary: by one bf16 ulp, at most 2^-7
# of |x|.  BF16_TOL's 1.6e-2 would exceed the outputs themselves at the
# full shapes (averages over up to 16384 keys: mean |x| ~ 2e-2), so each
# element is held to 2^-7 of its own size (atol 1e-5 for outputs that
# cancel to near zero, where the order of summation weighs more), and the
# whole output to 1e-3 relative L2 (one ulp on every element would give
# ~5e-3).
FLASH_FULL_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
FLASH_FULL_REL_L2 = 1e-3
# The bf16 flash kernel splits p into two bf16 terms (hi + lo) so that
# p.v keeps p to 2^-16: its p.v does twice the tensor-core work, so its
# own floor is 1.5 x the bound (q.k once, p.v twice).
SPLIT_P_WORK = 1.5
# bf16 instantiations of the flash kernel on the main paths (granite-8b's
# and zamba2-2.7b's head_dim): their SASS must hold wgmma instructions
# (HGMMA) and ptxas must report no spills.
FLASH_MAIN_DIMS = (128, 80)
# The long-prompt path: a dense engine whose largest bucket is past 8192.
LONG_S, LONG_MAX_SEQ = 16384, 16640
LONG_BUCKETS = (16, 64, 256, LONG_S)
LONG_PROMPTS = [9000, 12500, 16000, 40, 200]
# The hybrid route into the kernel: zamba2-2.7b's shared attention
# (head_dim 80) in a dense engine's bulk prefill at the 16384 bucket.  A
# recurrent model's bucket is the largest one its prompt fills, so the
# long prompt is past 16384 tokens and its last 15 tokens stream.
HYBRID_PROMPTS = [16400, 40]
# (model, prompts, batch size, prompts bulk-prefilled at LONG_S)
LONG_PATHS = (("granite-8b", LONG_PROMPTS, 4, 3),
              ("zamba2-2.7b", HYBRID_PROMPTS, 2, 1))
# One full-depth 16384-token prefill of granite-8b or zamba2-2.7b, kernel
# vs plain (``blockwise_attention``'s plain form), last-position logits:
# relative L2 and whether the greedy token agrees.  bf16: the plain form
# rounds the softmax weights to bf16 before p.v (as the reference does)
# and the kernel keeps them in float32, so every attention output differs
# by about one bf16 ulp, and 36 (54) layers of random weights amplify
# that, as in the decode step (BF16_STEP_TOL); random logits have near
# ties, so the
# greedy token is not held.  float32: the two differ in the order of
# summation only (~1e-7 relative per attention output).
BF16_LONG_TOL = dict(rel_l2=0.1, argmax_agree=0.0)
F32_LONG_TOL = dict(rel_l2=1e-4, argmax_agree=1.0)


def log(msg):
    print(msg, flush=True)


def lap(what, t0) -> float:
    """Log the wall seconds since ``t0`` under ``what``; returns now."""
    now = time.perf_counter()
    log(f"[time] {what}: {now - t0:.1f} s")
    return now


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


def busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def assert_close(a, b, tol, what):
    import torch
    ok = torch.allclose(a.float(), b.float(), **tol)
    log(f"  {what}: max_abs_err={max_err(a, b):.3e} tol={tol} ok={ok}")
    if not ok:
        raise AssertionError(f"{what} outside tolerance {tol}")


def paged_phase_inputs(dev, H, KV, D, kv_lens=None):
    """bf16 decode inputs at the main path's geometry (max_seq 1024, pool
    of 512 blocks of 16), one lane per entry of ``kv_lens`` (default the
    skewed mix): (q, k_pool, v_pool, block_tables, kv_len) on permuted
    pool rows, with sentinel table entries and garbage in unreferenced
    blocks."""
    import torch
    kv_len_host = list(PAGED_MIXES["skewed"] if kv_lens is None else kv_lens)
    B, bs, mb, NB = len(kv_len_host), 16, 64, 512
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
    kv_len = torch.tensor(kv_len_host, dtype=torch.int32, device=dev)
    return q, k_pool.bfloat16(), v_pool.bfloat16(), bt.to(dev), kv_len


def paged_check(args, what, hold_plain_rel_l2=True, out=None):
    """The paged kernel's output on bf16 ``args`` (``out``, or a call made
    here) vs the plain version in float32 on the same inputs with its
    output rounded to bf16 once (p unrounded, as the kernel keeps it: each
    output to ``PAGED_EXACT_P_TOL``, the whole to
    ``PAGED_EXACT_P_REL_L2``) and vs the plain version (each output to
    ``PAGED_BF16_TOL``, the whole to ``PAGED_BF16_REL_L2`` where
    ``hold_plain_rel_l2``, else logged), then a call in float32
    (``F32_TOL``); returns the bf16 max_abs_err against the plain
    version."""
    import torch
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    if out is None:
        out = kernel.paged_attention(*args)
    torch.cuda.synchronize()
    ref = paged_attention_ref(*args)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    f32 = [t.float() if t.is_floating_point() else t for t in args]
    ref32 = paged_attention_ref(*f32)
    assert_scaled(out, ref32.bfloat16(), PAGED_EXACT_P_TOL,
                  PAGED_EXACT_P_REL_L2,
                  f"{what} bf16 kernel vs plain in float32, rounded once")
    err, _ = assert_scaled(
        out, ref, PAGED_BF16_TOL,
        PAGED_BF16_REL_L2 if hold_plain_rel_l2 else None,
        f"{what} bf16 kernel vs plain")
    assert_close(kernel.paged_attention(*f32), ref32, F32_TOL,
                 f"{what} f32 kernel vs plain")
    return err


def paged_back_to_back(dev):
    """Three bf16 calls launched one after another with no sync between,
    each changing the geometry and the lanes' lengths, then each output
    held against the plain version as ``paged_check`` holds it; the
    kernel's per-(lane, kv head) counters are all zero after them."""
    from repro_torch.kernels.paged_attention import kernel
    calls = [("granite-8b one long lane", 32, 8, 128),
             ("zamba2-2.7b uniform", 32, 32, 80),
             ("granite-8b skewed", 32, 8, 128)]
    args = [paged_phase_inputs(dev, H, KV, D, PAGED_MIXES[w.split(" ", 1)[1]])
            for w, H, KV, D in calls]
    outs = [kernel.paged_attention(*a) for a in args]
    for (what, *_), a, out in zip(calls, args, outs):
        paged_check(a, f"back to back: {what}", what.endswith("skewed"), out)
    counters = kernel._counters[dev.index or 0]
    assert int(counters.abs().sum()) == 0, counters
    log(f"  {len(calls)} calls back to back: each within its limits, the "
        f"{counters.numel()} counters back to zero")


def paged_library(args):
    """The library yardstick on ``args``: gather + SDPA, as one callable
    (never called by the port)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention.ref import gather_pages
    q, k_pool, v_pool, bt, kv_len = args
    G = q.shape[1] // k_pool.shape[2]
    S = bt.shape[1] * k_pool.shape[1]
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)

    def library():
        k = gather_pages(k_pool, bt).transpose(1, 2)     # (B, KV, S, D)
        v = gather_pages(v_pool, bt).transpose(1, 2)
        if not gqa:
            k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
        mask = (torch.arange(S, device=q.device)[None, :]
                < kv_len[:, None])[:, None, None, :]
        extra = {"enable_gqa": True} if gqa else {}
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k, v, attn_mask=mask, **extra)[:, :, 0]
    return library


def paged_bound(args):
    """(bytes, flops, bound ms, bound_by) of one bf16 call on ``args``:
    the K and V rows below each lane's kv_len, q and the output, the
    table entries those rows need and kv_len, each once; q.k and p.v at
    2 operations a multiply-add."""
    q, k_pool, _, _, kv_len = args
    B, H, D = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    lens = kv_len.tolist()
    tokens = sum(lens)
    nbytes = (tokens * KV * D * 2 * 2                 # k and v rows, bf16
              + 2 * B * H * D * 2                     # q in, out
              + sum(-(-n // bs) for n in lens) * 4 + B * 4)
    flops = 4 * tokens * H * D
    hbm, ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (nbytes, flops, max(hbm, ops) * 1e3,
            "bytes" if hbm >= ops else "operations")


def paged_kernel_phase(dev, flush, H, KV, D):
    """Paged-attention kernel vs plain at decode shapes (bs=16, 64 table
    columns, pool of 512 blocks), for each lane mix of ``PAGED_MIXES``;
    returns the skewed mix's numbers with every mix's beside them."""
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    rows = {}
    for mix, lens in PAGED_MIXES.items():
        args = paged_phase_inputs(dev, H, KV, D, lens)
        err = paged_check(args, f"D={D} {mix}",
                          hold_plain_rel_l2=mix == "skewed")
        library = paged_library(args)
        assert_close(library(), paged_attention_ref(*args), BF16_TOL,
                     f"D={D} {mix} library vs plain")
        ms = cuda_ms(lambda: kernel.paged_attention(*args), 50, flush)
        warm_ms = cuda_ms(lambda: kernel.paged_attention(*args), 50)
        plain_ms = cuda_ms(lambda: paged_attention_ref(*args), 20, flush)
        library_ms = cuda_ms(library, 20, flush)
        nbytes, flops, bound_ms, bound_by = paged_bound(args)
        log(f"  D={D} {mix} (B={len(lens)}): kernel {ms:.4f} ms (L2 "
            f"flushed), {warm_ms:.4f} ms warm; plain {plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({nbytes} B, {flops} flop); {bound_ms / ms:.3f} of the bound")
        rows[mix] = {"max_abs_err": err, "ms": ms, "warm_ms": warm_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
    return {**rows["skewed"], "by_mix": rows}


def ssd_bound(l, h, p, n, bc=1):
    """(flops, bytes, bound ms, FFMA bound ms) of one intra-chunk call over
    ``bc`` = b * nc chunks: per chunk the causal half of C.B^T once (B and
    C are shared by the heads), per head the causal half of att @ xdt and
    the (p, n) state product, 2 operations per multiply-add; each input
    read and output written once in float32.  The bound is the kernel's
    route (3xTF32 on the tensor cores); the FFMA bound stands beside it."""
    tri = l * (l + 1) // 2
    flops = 2 * bc * (tri * n + h * tri * p + h * l * p * n)
    bytes_moved = 4 * bc * (2 * l * h * p + 2 * l * h + 2 * l * n + h * p * n)
    hbm = bytes_moved / HBM_BYTES_PER_S
    return (flops, bytes_moved, max(flops / TF32X3_FLOPS, hbm) * 1e3,
            max(flops / F32_FLOPS, hbm) * 1e3)


def ssd_phase_inputs(dev, bc, l, h, p, n, seed):
    """float32 intra-chunk inputs on the card, b = 1 and nc = bc: x, B, C
    standard normal, dt = softplus(normal), dAcs the cumsum over the chunk
    of -|normal| / 10; (xr, dtr, dA_cs, Br, Cr)."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    xr = randn(1, bc, l, h, p)
    dtr = torch.nn.functional.softplus(randn(1, bc, l, h))
    dA_cs = torch.cumsum(-randn(1, bc, l, h).abs() * 0.1, dim=2)
    return xr, dtr, dA_cs, randn(1, bc, l, n), randn(1, bc, l, n)


def ssd_check(args, what):
    """The SSD kernel vs its plain version on ``args``, y and the state
    each to ``SSD_RTOL`` and ``SSD_ATOL_OF_MAX`` of its largest output;
    returns the largest absolute error."""
    import torch
    from repro_torch.kernels.ssd import kernel, ssd_intra_chunk_ref
    y, st = kernel.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    y_ref, st_ref = ssd_intra_chunk_ref(*args)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    err = 0.0
    for name, a, b in (("y", y, y_ref), ("state", st, st_ref)):
        tol = dict(rtol=SSD_RTOL, atol=SSD_ATOL_OF_MAX * float(b.abs().max()))
        assert_close(a, b, tol, f"{what} {name} kernel vs plain")
        err = max(err, max_err(a, b))
    return err


def empty_launch_ms(dev, flush):
    """An empty kernel launched through the SSD library's ctypes path,
    timed as ``ssd_kernel_phase`` times the kernel: (cold, warm) ms."""
    from repro_torch.kernels.ssd import kernel
    return (cuda_ms(lambda: kernel.empty_launch(dev), 50, flush),
            cuda_ms(lambda: kernel.empty_launch(dev), 50))


def ssd_kernel_phase(dev, flush):
    """SSD kernel vs plain (float32) at the full models' prefill chunks
    and at zamba2-2.7b's long prefill (b * nc = 64); returns the record of
    mamba2-780m's 256-token chunk with every shape measured beside it."""
    from repro_torch.kernels.ssd import kernel, ssd_intra_chunk_ref
    empty_ms, empty_warm_ms = empty_launch_ms(dev, flush)
    log(f"  empty launch through the same ctypes path: {empty_ms:.4f} ms "
        f"(L2 flushed), {empty_warm_ms:.4f} ms warm")
    rows = []
    for model, bc, l, (h, p, n) in SSD_SHAPES:
        args = ssd_phase_inputs(dev, bc, l, h, p, n, seed=l + bc)
        err = ssd_check(args, f"{model} b*nc={bc} l={l}")
        ms = cuda_ms(lambda: kernel.ssd_intra_chunk(*args), 50, flush)
        # the same calls with the inputs left in L2: how much of the time
        # is a cold start rather than the work
        warm_ms = cuda_ms(lambda: kernel.ssd_intra_chunk(*args), 50)
        plain_ms = cuda_ms(lambda: ssd_intra_chunk_ref(*args), 20, flush)
        flops, nbytes, bound_ms, ffma_ms = ssd_bound(l, h, p, n, bc)
        bound_by = ("operations" if flops / TF32X3_FLOPS
                    >= nbytes / HBM_BYTES_PER_S else "bytes")
        tflops = flops / ms / 1e9
        log(f"  {model} b*nc={bc} l={l} (h={h} p={p} n={n}): kernel "
            f"{ms:.4f} ms ({warm_ms:.4f} ms with warm L2; empty launch "
            f"{empty_ms:.4f} / {empty_warm_ms:.4f}), plain {plain_ms:.4f} "
            f"ms, bound {bound_ms:.5f} ms ({bound_by}: {flops} flop, "
            f"{nbytes} B; 3xTF32 at {TF32X3_FLOPS / 1e12:.0f} TFLOP/s), FFMA "
            f"bound {ffma_ms:.5f} ms; {tflops:.2f} TFLOP/s, "
            f"{bound_ms / ms:.3f} of the bound, {ffma_ms / ms:.3f} of the "
            f"FFMA bound")
        rows.append({"model": model, "bc": bc, "l": l, "h": h, "p": p,
                     "n": n, "ms": ms, "warm_ms": warm_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "ffma_bound_ms": ffma_ms, "bound_by": bound_by,
                     "tflops": tflops, "flops": flops, "bytes": nbytes,
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
            "ffma_bound_ms": main["ffma_bound_ms"],
            "library_ms": None, "empty_launch_ms": empty_ms,
            "empty_launch_warm_ms": empty_warm_ms, "at_shapes": rows}


def ssd_build_phase():
    """The SSD kernel's instantiations as built: ptxas registers and
    spills of each (when this process built the library), and the
    tensor-core instructions (HMMA) in the SASS of each, which must hold
    some and, per ptxas, spill nothing."""
    from repro_torch.kernels import build
    report = ptxas_report(build.build_log.get("ssd", {}).get("ptxas", ""))
    if not report:
        log("  ssd: ptxas report not available (library built before this "
            "process)")
    for name, (regs, st, ld) in sorted(report.items()):
        log(f"  ptxas {name}: {regs} registers, spill stores {st} B, spill "
            f"loads {ld} B")
    counts = sass_op_counts(build.library_path("ssd"), "HMMA")
    names = sorted(k for k in counts if "ssd_intra_chunk_kernel<" in k)
    assert names, sorted(counts)
    found = {}
    for name in names:
        tag = name[name.index("ssd_intra_chunk_kernel<"):name.index(">") + 1]
        log(f"  SASS {tag}: HMMA {counts[name]}")
        assert counts[name] > 0, f"{tag}: no tensor-core instruction"
        spills = [v for k, v in report.items() if tag in k]
        assert all(st == ld == 0 for _, st, ld in spills), (tag, spills)
        found[tag] = {"HMMA": counts[name],
                      "ptxas": spills[0] if spills else None}
    return found


def paged_build_phase():
    """The paged kernel's instantiations as built: ptxas registers and
    spills of each (when this process built the library), which must
    spill nothing, and the tensor-core instructions (HMMA) in the SASS of
    the bf16 ones, which must hold some."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention.kernel import HEAD_DIMS
    report = ptxas_report(build.build_log.get("paged_attention", {})
                          .get("ptxas", ""))
    if not report:
        log("  paged_attention: ptxas report not available (library built "
            "before this process)")
    for name, (regs, st, ld) in sorted(report.items()):
        log(f"  ptxas {name}: {regs} registers, spill stores {st} B, spill "
            f"loads {ld} B")
        assert st == ld == 0, (name, st, ld)
    counts = sass_op_counts(build.library_path("paged_attention"), "HMMA")
    found = {}
    for d in HEAD_DIMS:
        tag = f"paged_attention_bf16_kernel<{d}>"
        names = [n for n in counts if tag in n]
        assert len(names) == 1, (tag, sorted(counts))
        log(f"  SASS {tag}: HMMA {counts[names[0]]}")
        assert counts[names[0]] > 0, f"{tag}: no tensor-core instruction"
        regs = [v for n, v in report.items() if tag in n]
        found[d] = {"HMMA": counts[names[0]],
                    "ptxas": regs[0] if regs else None}
    return found


def ssd_per_layer_est_ms(rows, arch, by_len, mamba_layers):
    """An estimate of the SSD kernel's device ms per Mamba2 layer over the
    main path's chunk prefills, priced from phase 4: each length's count
    per layer times the phase-4 time of ``arch`` at that length (one call,
    L2 flushed, b * nc = 1).  Not measured inside the engine."""
    ms = {r["l"]: r["ms"] for r in rows if r["model"] == arch and r["bc"] == 1}
    per_layer = sum(c // mamba_layers * ms[k] for k, c in by_len.items())
    log(f"  {arch}: SSD kernel ~{per_layer:.4f} ms per Mamba2 layer over the "
        f"path's chunk prefills (an estimate: phase-4 times at each length)")
    return per_layer


def jacobi_kernel_phase(dev, flush):
    """The Jacobi kernel vs its plain version, bit for bit, and its times
    at the full grids; returns the record at 16384^2 float32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.jacobi import jacobi_step_ref, kernel
    g = torch.Generator(dev).manual_seed(4)
    err = 0.0
    for H, W in JACOBI_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            grid = torch.randn(H, W, generator=g, device=dev).to(dtype)
            out = kernel.jacobi_step(grid)
            torch.cuda.synchronize()
            ref = jacobi_step_ref(grid)
            assert out.dtype == dtype and out.shape == ref.shape
            # both round after every op, in the same order: equal bits
            assert torch.equal(out, ref), (H, W, dtype, max_err(out, ref))
            err = max(err, max_err(out, ref))
        log(f"  {H}x{W} float32 and bf16: kernel == plain (max_abs_err 0)")
    rows = []
    for n in JACOBI_FULL:
        grid = torch.randn(n, n, generator=g, device=dev)
        out = kernel.jacobi_step(grid)
        torch.cuda.synchronize()
        assert torch.equal(out, jacobi_step_ref(grid)), n
        ms = cuda_ms(lambda: kernel.jacobi_step(grid), 20, flush)
        plain_ms = cuda_ms(lambda: jacobi_step_ref(grid), 5, flush)
        # the yardstick: one cuDNN convolution (float32, TF32 off) of the
        # grid padded with its boundary, padding outside the timing
        padded = F.pad(grid, (1, 1, 1, 1))
        padded[0, 1:-1] = 1.0
        padded = padded[None, None]
        cross = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                              [0.0, 0.25, 0.0]], device=dev)[None, None]
        assert_close(F.conv2d(padded, cross)[0, 0], out,
                     dict(rtol=1e-5, atol=1e-5),
                     f"{n}^2 conv2d (library) vs kernel")
        library_ms = cuda_ms(lambda: F.conv2d(padded, cross), 10, flush)
        del padded, out, grid
        torch.cuda.empty_cache()
        nbytes, flops = 2 * n * n * 4, 4 * n * n
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        log(f"  {n}^2 float32: kernel == plain; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, conv2d {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms "
            f"(bytes: {nbytes} B; {flops} flop); {bound_ms / ms:.1%} of "
            f"the HBM rate")
        rows.append({"n": n, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes", "max_abs_err": 0.0})
    main = rows[0]
    return {"name": "jacobi", "route": "cuda",
            "source": "src/repro_torch/csrc/jacobi.cu",
            "replaces": "src/repro/kernels/jacobi/kernel.py:40",
            "launches": None, "max_abs_err": err,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "at_shapes": rows}


def stencil_runtime(dev, odf, n_pes=STENCIL_PES, **kw):
    """A full-size tile runtime: 16384^2 float32 over ``n_pes * odf``
    near-square tiles."""
    from repro_torch.core.overdecomp import (HostTileRuntime, TileGrid,
                                             choose_tiling)
    tr, tc = choose_tiling(n_pes * odf)
    return HostTileRuntime(TileGrid(STENCIL_N, STENCIL_N, tr, tc), n_pes,
                           odf=odf, device=dev, **kw)


def slow_pe_balance(rt, pe=2) -> int:
    """Rate-aware GreedyRefine on a fresh monitor that read ``pe`` 4x
    slower: moves tiles whatever the card measured."""
    from repro_torch.core.rates import RateMonitor
    secs = [1.0] * rt.n_pes
    secs[pe] = 4.0
    rt.monitor = RateMonitor(rt.n_pes)
    rt.monitor.record_step([float(rt.odf)] * rt.n_pes, secs)
    return rt.load_balance("greedy_refine").migrations


def pes_holding(rt) -> int:
    import numpy as np
    return int((np.bincount(rt.assignment, minlength=rt.n_pes) > 0).sum())


def tile_form_phase(dev, flush):
    """One PE's tile launch at full size, after a load balance moved
    tiles onto it, against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels.jacobi import jacobi_tiles, jacobi_tiles_ref
    rt = stencil_runtime(dev, 4)
    rt.tiles.uniform_(generator=torch.Generator(dev).manual_seed(6))
    moved = slow_pe_balance(rt)
    assert moved > 0
    home = np.arange(rt.grid.n_tiles) % rt.n_pes
    pe = int(rt.assignment[np.nonzero(rt.assignment != home)[0][0]])
    ids = rt.pe_ids(pe)
    out = torch.full_like(rt.tiles, float("nan"))
    jacobi_tiles(rt.tiles, ids, rt.nbr, out)
    torch.cuda.synchronize()
    ref = jacobi_tiles_ref(rt.tiles, ids, rt.nbr)
    assert torch.equal(out[ids.long()], ref)
    others = [t for t in range(rt.grid.n_tiles) if rt.assignment[t] != pe]
    assert torch.isnan(out[others]).all()      # nothing else written
    ms = cuda_ms(lambda: jacobi_tiles(rt.tiles, ids, rt.nbr, out), 20, flush)
    plain_ms = cuda_ms(lambda: jacobi_tiles_ref(rt.tiles, ids, rt.nbr), 5,
                       flush)
    h, w = rt.grid.tile_shape
    bound_ms = 2 * len(ids) * h * w * 4 / HBM_BYTES_PER_S * 1e3
    log(f"  {moved} tiles moved; PE {pe} holds {len(ids)} tiles of {h}x{w}:"
        f" kernel == plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms")
    return {"moved": moved, "tiles": len(ids), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms}


def stencil_app_phase(dev):
    """C1 and C2 at full size through the app's entry points; returns the
    Jacobi kernel's launches by run."""
    import numpy as np
    import torch
    from repro_torch.apps.jacobi2d import run_jacobi
    from repro_torch.apps.lulesh_proxy import run_lulesh
    from repro_torch.kernels.jacobi import kernel as jk
    launches = {}
    for odf in STENCIL_ODFS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        jk.launches = 0
        t0 = time.perf_counter()
        out = run_jacobi(grid_size=STENCIL_N, n_pes=STENCIL_PES, odf=odf,
                         iters=C1_ITERS, comm_latency_s=500e-6, device=dev)
        wall = time.perf_counter() - t0
        launches[f"jacobi2d odf={odf}"] = jk.launches
        assert jk.launches == C1_ITERS * STENCIL_PES, jk.launches
        steps = out.per_iter
        compute = np.mean([m["compute_max"] for m in steps])
        exposed = np.mean([m["comm_exposed_max"] for m in steps])
        log(f"[C1] {STENCIL_N}^2 f32, {STENCIL_PES} PEs, odf {odf}, 500 us "
            f"latency: time/iter {out.time_per_iter * 1e3:.4f} ms, "
            f"accounted {out.accounted_time_per_iter * 1e3:.4f} ms, "
            f"compute max {compute * 1e3:.4f} ms, exposed comm "
            f"{exposed * 1e3:.4f} ms (means over {len(steps)} steps); "
            f"{jk.launches} launches; "
            f"{C1_ITERS} iters in {wall:.2f} s wall incl. set-up; peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    res = {}
    for strat, aware in ((None, False), ("greedy_refine", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run_lulesh(grid_size=STENCIL_N, n_pes=STENCIL_PES, odf=4,
                         iters=C2_ITERS, pe_rate_multipliers=C2_RATES,
                         lb_strategy=strat, lb_every=6, rate_aware=aware,
                         device=dev)
        wall = time.perf_counter() - t0
        tail = out.per_iter[-8:]
        res[strat] = float(np.median([m["accounted_time_per_iter"]
                                      for m in tail]))
        log(f"[C2] lulesh {STENCIL_N}^2 f32, rates {C2_RATES}, lb {strat}: "
            f"time/iter {out.time_per_iter * 1e3:.3f} ms, accounted "
            f"{out.accounted_time_per_iter * 1e3:.3f} ms, tail median "
            f"accounted {res[strat] * 1e3:.3f} ms, migrations "
            f"{[e['migrations'] for e in out.lb_events]}; {C2_ITERS} iters "
            f"in {wall:.2f} s wall; peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[C2] rate-aware GreedyRefine vs no LB: improvement "
        f"{1 - res['greedy_refine'] / res[None]:.4f} (accounted, tail "
        f"median)")
    return launches


def spread(xs, scale=1e3) -> str:
    """Median [p10, p90] (min-max) of ``xs`` times ``scale``."""
    import numpy as np
    p10, med, p90 = np.percentile(xs, [10, 50, 90]) * scale
    return (f"{med:.4f} [p10 {p10:.4f}, p90 {p90:.4f}] (min "
            f"{min(xs) * scale:.4f}, max {max(xs) * scale:.4f})")


def stencil_steady_phase(dev):
    """A fresh full-size runtime in a process that has not loaded the
    Jacobi kernel: the first step's per-PE device times against their
    medians over a steady window, and the window's wall and busy time per
    step; then the LULESH proxy's first timed step (after its untimed
    first run) against its next ones.
    Returns the Jacobi kernel's launches."""
    import numpy as np
    import torch
    from repro_torch.kernels.jacobi import kernel as jk
    assert jk._fn is None, "the Jacobi kernel is loaded already"
    jk.launches = 0
    rt = stencil_runtime(dev, 4)
    rt.step()                       # loads the kernel before its timing
    first = rt.last_pe_compute.copy()
    walls, busy, per_pe = [], [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(STEADY_STEPS):
            t0 = time.perf_counter()
            rt.step()               # ends in its sync: the host clock holds
            walls.append(time.perf_counter() - t0)
            busy.append(float(rt.last_pe_compute.sum()))
            per_pe.append(rt.last_pe_compute.copy())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = jk.launches
    assert rt.host_syncs == STEADY_STEPS + 1
    assert launches == (STEADY_STEPS + 1) * STENCIL_PES, launches
    med = np.median(per_pe, axis=0)
    log(f"[stencil] fresh runtime, 4 PEs x 4 tiles: step 1 per-PE device "
        f"ms {[round(float(x) * 1e3, 4) for x in first]} (PE 0 launched "
        f"first) against the window's per-PE medians "
        f"{[round(float(x) * 1e3, 4) for x in med]}: ratios "
        f"{[round(float(x), 4) for x in first / med]}")
    host = [w - b for w, b in zip(walls, busy)]
    log(f"[stencil] steady window, {STEADY_STEPS} steps, 1 host sync each "
        f"(sync_debug_mode=error): wall ms/step {spread(walls)}; kernels "
        f"ms/step {spread(busy)}; host ms/step (wall - kernels) "
        f"{spread(host)}; device busy share "
        f"{spread([b / w for b, w in zip(busy, walls)], 1)}; mean wall "
        f"{np.mean(walls) * 1e3:.4f} ms")
    # equal work on every PE: the measured rates show the timing's bias
    log(f"[stencil] per-PE rates the monitor measured on equal work "
        f"(EWMA, mean 1): {[round(float(r), 4) for r in rt.monitor.rates()]}")
    del rt
    lu = stencil_runtime(dev, 4, kernel="lulesh")
    steps = []
    for _ in range(6):
        lu.step()
        steps.append(lu.last_pe_compute.copy())
    med = np.median(steps[1:], axis=0)
    log(f"[stencil] fresh LULESH runtime: timed step 1 per-PE device ms "
        f"{[round(float(x) * 1e3, 3) for x in steps[0]]} against the "
        f"medians of steps 2-6 {[round(float(x) * 1e3, 3) for x in med]}: "
        f"ratios {[round(float(x), 4) for x in steps[0] / med]}")
    del lu
    torch.cuda.empty_cache()
    return launches


def stencil_checks_phase(dev):
    """The app's correctness on the card, asserted."""
    import numpy as np
    import torch
    from repro_torch.core.spmd_stencil import reference_jacobi
    from repro_torch.kernels.jacobi import jacobi
    from repro_torch.kernels.jacobi import kernel as jk
    a, b = stencil_runtime(dev, 4), stencil_runtime(dev, 4)
    a.tiles.uniform_(generator=torch.Generator(dev).manual_seed(7))
    b.tiles.copy_(a.tiles)
    g0 = a.device_grid()
    jk.launches = 0
    want = 0
    for i in range(6):
        if i == 2:
            assert slow_pe_balance(b) > 0
        if i == 4:
            b.assignment = np.random.default_rng(0).integers(0, 3, 16)
        a.step()
        b.step()
        want += pes_holding(a) + pes_holding(b)
    torch.cuda.synchronize()
    assert jk.launches == want, (jk.launches, want)
    assert a.host_syncs == b.host_syncs == 6
    assert torch.equal(a.tiles, b.tiles)
    ref = reference_jacobi(g0, 6)
    assert torch.equal(a.device_grid(), ref)
    swept = g0
    for _ in range(6):
        swept = jacobi(swept)
    assert torch.equal(swept, ref)
    del b, ref, swept, g0
    h, w = a.grid.tile_shape
    log(f"[stencil] 6 steps, 4 PEs x 4 tiles of {h}x{w}: tiled == "
        f"reference_jacobi (plain) == 6 global kernel sweeps, bit for bit; "
        f"moved run == unmoved; {want} launches, 1 host sync a step")
    # shrink 4 -> 2 PEs through a host checkpoint, continue
    snap = a.checkpoint()
    c = stencil_runtime(dev, 8, n_pes=2)
    c.restore(snap, n_pes=2)
    assert torch.equal(c.tiles, a.tiles)
    for _ in range(3):
        a.step()
        c.step()
    assert torch.equal(c.tiles, a.tiles) and c.iteration == a.iteration
    log("[stencil] 4 -> 2 PE checkpoint/restore continues bit-identically")


def stencil_driver_phase(dev):
    """``TileRuntimeDriver`` with a ``FaultTrace`` at full size; returns
    its Jacobi launches."""
    from repro_torch.core.overdecomp import TileRuntimeDriver
    from repro_torch.kernels.jacobi import kernel as jk
    from repro_torch.runtime import EventLoop, FaultTrace
    rt = stencil_runtime(dev, 4)
    loop = EventLoop()
    trace = FaultTrace(rebalance_lead=2.0, notice_deadline=2.0)
    trace.inject(3.0, 0)
    jk.launches = 0
    drv = TileRuntimeDriver(rt, loop, iters=10, step_interval=1.0,
                            lb_interval=4.0, trace=trace)
    loop.run()
    launches = jk.launches
    assert rt.iteration == 10 and pes_holding(rt) == STENCIL_PES
    assert launches == 10 * STENCIL_PES, launches
    assert [t for t, _ in drv.checkpoints] == [5.0]
    # at t = 5.0 the notice (bound first) is dispatched before the step
    assert drv.checkpoints[0][1]["iteration"] == 4
    assert any(t == 3.0 and msg.startswith("lb") for t, msg in drv.timeline)
    log(f"[driver] 10 steps on the event loop: checkpoint at t=5.0 (the "
        f"notice), timeline {drv.timeline}; {launches} launches")
    return launches


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
    params, launches by kernel, the steady requests, SSD launches by
    chunk length)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.checkpointing import tree_leaves
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = zoo.init_serving_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    draw_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    weight_gb = sum(t.nbytes for t in tree_leaves(params)) / 1e9
    log(f"[engine] {arch} {cfg.num_layers} layers d={cfg.d_model} "
        f"params={zoo.num_params(cfg)} (active {zoo.active_params(cfg)}; "
        f"{weight_gb:.2f} GB) drawn in {time.perf_counter() - t0:.1f} s, "
        f"peak {draw_peak:.1f} GiB while drawing")
    engine = ServingEngine(cfg, params, batch_size=8, max_seq=1024,
                           block_size=16, cache_mode="paged", device=dev)
    reqs = requests(cfg, PROMPT_LENS, 32, seed=0)
    for r in reqs:
        engine.submit(r)
    pa.launches = ssd.launches = 0
    ssd.launches_by_len.clear()
    stats = engine.run_until_idle()
    torch.cuda.synchronize()
    launches = {"paged_attention": pa.launches,
                "ssd_intra_chunk": ssd.launches}
    by_len = dict(sorted(ssd.launches_by_len.items()))
    assert sum(by_len.values()) == ssd.launches, (by_len, ssd.launches)
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
    if mamba_layers:
        assert all(c % mamba_layers == 0 for c in by_len.values()), by_len
        log(f"  SSD launches by chunk length {by_len}: chunk prefills per "
            f"Mamba2 layer by length "
            f"{ {k: c // mamba_layers for k, c in by_len.items()} }")

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
    return engine, params, launches, steady, by_len


def moe_block_timing(cfg, params, dev):
    """Device ms of one ``moe_block`` on layer 0's weights at decode (8
    lanes of one token: one routing group, capacity 8) and at one
    256-token chunk (16 groups of 16, capacity 8), beside its bound: the
    block's weight bytes over the HBM rate (``_moe_grouped`` multiplies
    every expert's whole capacity buffer, so it reads every expert)."""
    import torch
    from repro_torch.device import dtype_of
    from repro_torch.models import moe as moe_lib
    lp = params["layers"][0]["moe"]
    nbytes = sum(t.nbytes for t in lp.values())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    g = torch.Generator(dev).manual_seed(2)
    out = {"weight_bytes": nbytes, "bound_ms": bound_ms}
    for what, shape in (("decode", (8, 1)), ("chunk 256", (1, 256))):
        x = torch.randn(*shape, cfg.d_model, generator=g, device=dev).to(
            dtype_of(cfg.compute_dtype))
        y, _ = moe_lib.moe_block(lp, x, cfg)
        assert y.shape == x.shape and torch.isfinite(y).all()
        ms = cuda_ms(lambda: moe_lib.moe_block(lp, x, cfg), 20)
        log(f"  moe_block {what} ({shape[0] * shape[1]} tokens): {ms:.4f} ms "
            f"device, bound {bound_ms:.4f} ms ({nbytes} B of weights at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {bound_ms / ms:.3f} of it")
        out[what] = ms
    return out


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


@contextlib.contextmanager
def ssd_core(kind):
    """Every SSD core call computes the plain version in float64, its
    outputs rounded once to float32 (``"f64"``: the most exact core a
    float32 run can have), or in single-pass TF32 (``"tf32"``: a control
    core ~1e-3 off per output, which the float32 check must refuse)."""
    import torch
    from repro_torch.kernels.ssd import ops, ssd_intra_chunk_ref
    saved = ops.ssd_intra_chunk

    def f64(xr, dtr, dA_cs, Br, Cr, *, impl="kernel"):
        y, st = ssd_intra_chunk_ref(
            *[t.double() for t in (xr, dtr, dA_cs, Br, Cr)])
        return y.float(), st.float()

    def tf32(xr, dtr, dA_cs, Br, Cr, *, impl="kernel"):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return ssd_intra_chunk_ref(xr, dtr, dA_cs, Br, Cr)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    ops.ssd_intra_chunk = {"f64": f64, "tf32": tf32}[kind]
    try:
        yield
    finally:
        ops.ssd_intra_chunk = saved


def prefill_step_vs_plain(cfg, params, dev, tol):
    """A 256-token paged chunk prefill into lane 0 plus one serve step,
    with the kernels and with ``impl="ref"`` (with ``f64_ratio`` in
    ``tol``, also with the exact and the control SSD cores of
    ``ssd_core``), from one fresh state each, for each token sequence of
    ``tol["seeds"]`` (default one): lane 0's logits and the SSD state of
    every layer, their relative L2 distances taken as the root mean square
    over the sequences."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model_zoo as zoo
    shape, bs, nb = ShapeConfig("serve", 1024, 8, "decode"), 16, 512
    lane = 1 if cfg.family == "ssm" else 2      # lane axis of "ssm"
    runs = [("kernel", "kernel"), ("plain", "ref")]
    if "f64_ratio" in tol:
        runs += [("f64", "ref"), ("tf32", "ref")]
    seeds = tol.get("seeds", (3,))
    sq = {}          # (a, b) -> sums of squared distances, logits and state
    agree = 0.0
    for seed in seeds:
        g = torch.Generator(dev).manual_seed(seed)
        toks = torch.randint(0, cfg.vocab_size, (1, 257), generator=g,
                             device=dev, dtype=torch.int32)
        outs = {}
        for name, impl in runs:
            core = (ssd_core(name) if name in ("f64", "tf32")
                    else contextlib.nullcontext())
            with core:
                state = zoo.init_paged_decode_state(cfg, shape, bs, nb, dev)
                state.block_tables[0, :17] = torch.arange(
                    17, dtype=torch.int32, device=dev)
                prefill = zoo.make_paged_bulk_prefill(
                    cfg, shape, 256, bs, nb, first_chunk=True, impl=impl)
                state = prefill(params, state, toks[:, :256], 0, 0, 256)
                step = zoo.make_paged_serve_step(cfg, shape, bs, nb,
                                                 impl=impl)
                tok = torch.zeros((8, 1), dtype=torch.int32, device=dev)
                tok[0] = toks[0, 256]
                active = torch.zeros(8, dtype=torch.int32, device=dev)
                active[0] = 1
                logits, state = step(params, state, tok, active)
                outs[name] = (logits[0, -1, :cfg.vocab_size].float(),
                              state.cache["ssm"].select(lane, 0).clone())
                del state
        torch.cuda.synchronize()
        a, sa = outs["kernel"]
        assert torch.isfinite(a).all() and torch.isfinite(sa).all()
        pairs = [("kernel", "plain")]
        if "f64" in outs:
            pairs += [(k, "f64") for k in ("kernel", "plain", "tf32")]
        line = []
        for x, y in pairs:
            d = (rel_l2(outs[x][0], outs[y][0]),
                 rel_l2(outs[x][1], outs[y][1]))
            old = sq.get((x, y), (0.0, 0.0))
            sq[(x, y)] = (old[0] + d[0] ** 2, old[1] + d[1] ** 2)
            line.append(f"{x} vs {y} logits {d[0]:.3e} state {d[1]:.3e}")
        tops = {int(o.argmax()) for k, (o, _) in outs.items()
                if k != "tf32"}
        agree += float(len(tops) == 1) / len(seeds)
        log(f"[prefill+step {cfg.name} {cfg.compute_dtype} tokens "
            f"{seed}] at full depth: {'; '.join(line)}; greedy tokens "
            f"{'agree' if len(tops) == 1 else 'differ'}")
    rms = {k: ((v[0] / len(seeds)) ** 0.5, (v[1] / len(seeds)) ** 0.5)
           for k, v in sq.items()}
    rel, srel = rms[("kernel", "plain")]
    log(f"[prefill+step {cfg.name} {cfg.compute_dtype}] kernels vs plain "
        f"over {len(seeds)} token sequence(s): logits rel_l2={rel:.3e}, SSD "
        f"state rel_l2={srel:.3e}, argmax agreement {agree:.2f} (tol {tol})")
    assert rel <= tol["rel_l2"] and srel <= tol["state_rel_l2"]
    assert agree >= tol["argmax_agree"]
    if "f64_ratio" in tol:
        far = {k: rms[(k, "f64")] for k in ("kernel", "plain", "tf32")}
        log("  from the exact-core run: " + "; ".join(
            f"{k} logits {v[0]:.3e} state {v[1]:.3e}"
            for k, v in far.items()))
        for i in (0, 1):
            assert far["kernel"][i] <= tol["f64_ratio"] * far["plain"][i], far
            assert far["tf32"][i] > tol["f64_ratio"] * far["plain"][i], far


def flash_bound(S, H, KV, D, elem_bytes, peak):
    """(flops, bytes, bound ms) of one causal call: q.k and p.v over the
    S (S + 1) / 2 attended pairs of each head, 2 operations a
    multiply-add; q, k and v read once and the output written once."""
    flops = 4 * H * D * S * (S + 1) // 2
    nbytes = elem_bytes * D * S * (2 * H + 2 * KV)
    return flops, nbytes, max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3


def assert_scaled(out, ref, tol, rel_l2_max, what):
    """Kernel vs plain, each element held to ``rtol * |ref|`` plus
    ``atol`` (or ``atol_of_row_rms`` times the RMS of its row, the last
    dimension) and the whole output to ``rel_l2_max`` relative L2 (None:
    logged, not held); logs the readings beside the limits and returns
    (max_abs_err, rel_l2)."""
    a, b = out.float(), ref.float()
    diff = (a - b).abs()
    atol, row = tol.get("atol", 0.0), ""
    if "atol_of_row_rms" in tol:
        rms = b.pow(2).mean(-1, keepdim=True).sqrt()
        atol = tol["atol_of_row_rms"] * rms
        excess = float(((diff - tol["rtol"] * b.abs()) / rms).max())
        row = f"largest (|diff| - rtol |ref|) / row RMS {excess:.3e}, "
    limit = atol + tol["rtol"] * b.abs()
    ok = bool((diff <= limit).all())
    rel, e = rel_l2(a, b), float(diff.max())
    worst = float((diff / limit).max())     # <= 1 within the limit
    differ = float((diff > 0).float().mean())
    log(f"  {what}: max_abs_err={e:.3e}, largest |diff| / limit "
        f"{worst:.3f}, {row}rel_l2={rel:.3e}, {differ:.2e} of elements "
        f"differ, "
        f"mean |ref|={float(b.abs().mean()):.3e}; tol {tol} per element, "
        f"rel_l2 <= {rel_l2_max}; ok={ok}")
    if not ok or (rel_l2_max is not None and rel > rel_l2_max):
        raise AssertionError(f"{what} outside tolerance")
    return e, rel


def demangle(names):
    """C++ names of mangled symbols (``c++filt``), or the names as they
    are where the tool is missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return list(names)
    return out if len(out) == len(names) else list(names)


def ptxas_report(log_text):
    """{kernel: (registers, spill store bytes, spill load bytes)} from a
    ``ptxas -v`` report, kernels by their C++ names."""
    rows, name, spill = {}, None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows[name] = (int(m.group(1)), *spill)
            name = None
    return dict(zip(demangle(list(rows)), rows.values()))


def sass_op_counts(lib_path, op):
    """{kernel: count of ``op``} over the SASS of a built library
    (``cuobjdump -sass``), kernels by their C++ names."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and re.search(rf"\b{op}\b", line):
            counts[cur] += 1
    return dict(zip(demangle(list(counts)), counts.values()))


def flash_build_phase():
    """The flash kernel's instantiations as built: ptxas registers and
    spills of each (when this process built it), and the wgmma (HGMMA)
    instructions in the SASS of the bf16 ones on the main paths, which
    must hold some and, per ptxas, spill nothing."""
    from repro_torch.kernels import build
    report = ptxas_report(build.build_log.get("flash_attention", {})
                          .get("ptxas", ""))
    if not report:
        log("  flash_attention: ptxas report not available (library built "
            "before this process)")
    for name, (regs, st, ld) in sorted(report.items()):
        log(f"  ptxas {name}: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")
    counts = sass_op_counts(build.library_path("flash_attention"), "HGMMA")
    found = {}
    for d in FLASH_MAIN_DIMS:
        tag = f"flash_attention_bf16_kernel<{d}>"
        names = [n for n in counts if tag in n]
        assert len(names) == 1, (tag, sorted(counts))
        hgmma = counts[names[0]]
        log(f"  SASS {names[0]}: HGMMA {hgmma}")
        assert hgmma > 0, f"{tag}: no wgmma instruction"
        spills = [v for n, v in report.items() if tag in n]
        assert all(st == ld == 0 for _, st, ld in spills), (tag, spills)
        found[d] = {"HGMMA": hgmma, "ptxas": spills[0] if spills else None}
    return found


def flash_kernel_phase(dev, flush):
    """The flash kernel vs its plain version at the test shapes and at
    both full prefill shapes; returns the record at granite-8b's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_ref,
                                                     flash_ref, kernel)
    g = torch.Generator(dev).manual_seed(8)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    err = 0.0
    for b, h, kv, s, d, bq, bkv in FLASH_SHAPES:
        for causal in (True, False):
            q, k, v = randn(b, h, s, d), randn(b, kv, s, d), randn(b, kv, s, d)
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, FLASH_FULL_TOL)):
                args = [t.to(dtype) for t in (q, k, v)]
                out = kernel.flash_attention(*args, causal=causal)
                torch.cuda.synchronize()
                ref = flash_attention_ref(*args, causal=causal, block_q=bq,
                                          block_kv=bkv)
                assert out.dtype == dtype and torch.isfinite(out).all()
                assert_close(out, ref, tol, f"{(b, h, kv, s, d)} causal="
                             f"{causal} {dtype} kernel vs plain")
                err = max(err, max_err(out, ref))
                if dtype == torch.bfloat16:
                    full = max_err(out, flash_ref(*args, causal=causal))
                    assert full < 3e-2, full
    rows = []
    for model, H, KV, D in FLASH_FULL:
        S = LONG_S
        # the model's (B, S, H, D) tensors, seen heads-major
        q = randn(1, S, H, D).bfloat16().transpose(1, 2)
        k = randn(1, S, KV, D).bfloat16().transpose(1, 2)
        v = randn(1, S, KV, D).bfloat16().transpose(1, 2)
        out = kernel.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=True)
        assert torch.isfinite(out).all() and out.transpose(1, 2)\
            .is_contiguous()
        e, rel = assert_scaled(out, ref, FLASH_FULL_TOL, FLASH_FULL_REL_L2,
                               f"{model} S={S} bf16 kernel vs plain")
        kr = k.repeat_interleave(H // KV, 1)      # outside the timing
        vr = v.repeat_interleave(H // KV, 1)

        def library():
            return F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
        lib_err = max_err(library(), ref)
        assert lib_err < 3e-2, lib_err
        ms = cuda_ms(lambda: kernel.flash_attention(q, k, v, causal=True), 5,
                     flush)
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                           2, flush)
        library_ms = cuda_ms(library, 10, flush)
        flops, nbytes, bound_ms = flash_bound(S, H, KV, D, 2, BF16_FLOPS)
        row = {"model": model, "S": S, "H": H, "KV": KV, "D": D,
               "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "operations", "flops": flops, "bytes": nbytes,
               "max_abs_err": e, "rel_l2": rel,
               "library_max_abs_err": lib_err}
        if model == "granite-8b":
            # the float32 prefill path's call (FFMA, no TF32), kernel only
            q32, k32, v32 = q.float(), k.float(), v.float()
            row["f32_ms"] = cuda_ms(lambda: kernel.flash_attention(
                q32, k32, v32, causal=True), 3, flush)
            row["f32_bound_ms"] = flash_bound(S, H, KV, D, 4, F32_FLOPS)[2]
            del q32, k32, v32
        floor_ms = SPLIT_P_WORK * bound_ms
        row.update(tflops=flops / ms / 1e9, share_of_bound=bound_ms / ms,
                   split_p_floor_ms=floor_ms,
                   share_of_split_p_floor=floor_ms / ms,
                   ratio_to_library=ms / library_ms)
        log(f"  {model} S={S} H={H} KV={KV} D={D} bf16 causal: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA) "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms (operations: "
            f"{flops} flop, {nbytes} B); {row['tflops']:.2f} TFLOP/s, "
            f"{row['share_of_bound']:.3f} of the bound, split-p floor "
            f"{floor_ms:.4f} ms ({row['share_of_split_p_floor']:.3f} of it), "
            f"{row['ratio_to_library']:.3f}x SDPA in this call"
            + (f"; float32 kernel {row['f32_ms']:.4f} ms, bound "
               f"{row['f32_bound_ms']:.4f} ms" if "f32_ms" in row else ""))
        rows.append(row)
        del q, k, v, out, ref, kr, vr
        torch.cuda.empty_cache()
    main = rows[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:69",
            "launches": None, "max_abs_err": max(err, main["max_abs_err"]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "at_shapes": rows}


def long_engine_phase(arch, prompts, batch_size, dev):
    """A dense engine on full-width ``arch`` (buckets up to 16384) serves
    ``prompts`` with 16 new tokens each, the flash and SSD launch counts
    set to 0 just before and read just after: flash = the attention
    layers x the bulk prefills at 16384, SSD = the Mamba2 layers x every
    bulk prefill.  Returns (engine, params, the long prompts' requests,
    flash launches on the path)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config(arch)
    params = zoo.init_serving_params(cfg, seed=0, device=dev)
    engine = ServingEngine(cfg, params, batch_size=batch_size,
                           max_seq=LONG_MAX_SEQ, prefill_buckets=LONG_BUCKETS,
                           cache_mode="dense", device=dev)
    reqs = requests(cfg, prompts, 16, seed=5)
    for r in reqs:
        engine.submit(r)
    long = [r for r in reqs
            if engine._pick_chunk(len(r.prompt) - 1)[0] == LONG_S]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.launches = sk.launches = 0
    stats = engine.run_until_idle()
    torch.cuda.synchronize()
    launches = {"flash_attention": fk.launches, "ssd_intra_chunk": sk.launches}
    for r in reqs:
        assert r.done and len(r.out_tokens) == 16, (r.rid, r.out_tokens)
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
    attn = zoo._attn_layers(cfg)
    mamba = 0 if cfg.family == "dense" else cfg.num_layers
    want = {"flash_attention": attn * len(long),
            "ssd_intra_chunk": mamba * engine.chunk_prefills}
    assert long and engine.chunk_prefills == len(reqs)
    assert launches == want, (launches, want)
    log(f"[long] {arch} dense engine, prompts {prompts}: served "
        f"{len(reqs)}/{len(reqs)}, {stats['tokens']} tokens, "
        f"{stats['steps']} decode steps, {stats['seconds']:.2f} s; launches "
        f"{launches} = {attn} x {len(long)} bulk prefills at {LONG_S}, "
        f"{mamba} x {engine.chunk_prefills} bulk prefills; peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return engine, params, long, launches["flash_attention"]


def long_prefill_profile(engine, params, req):
    """One more 16384-token bulk prefill of ``req`` into slot 0 of the idle
    engine: wall time, then under the profiler the device's busy share
    and the flash and SSD kernels' parts of it (as many launches of each
    in the trace as the prefill counted).  Returns those readings."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.models import model_zoo as zoo
    cfg = engine.cfg
    bulk = zoo.make_bulk_prefill(cfg, engine.shape, LONG_S)
    n_real = min(len(req.prompt) - 1, LONG_S)
    toks = engine._chunk_tokens(req, 0, LONG_S, n_real)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bulk(params, engine.state, toks, 0, n_real)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    before, ssd_before = fk.launches, sk.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bulk(params, engine.state, toks, 0, n_real)
        torch.cuda.synchronize()
    launched = fk.launches - before
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels]) / 1e3
    flash = [e for e in kernels if "flash_attention_" in e.name]
    assert len(flash) == launched > 0, (len(flash), launched)
    flash_ms = sum(e.time_range.elapsed_us() for e in flash) / 1e3
    ssd = [e for e in kernels if "ssd_intra_chunk_kernel" in e.name]
    assert len(ssd) == sk.launches - ssd_before, (len(ssd), sk.launches)
    ssd_ms = sum(e.time_range.elapsed_us() for e in ssd) / 1e3
    wall_ms = walls[-1] * 1e3
    rest = len(kernels) - len(flash) - len(ssd)
    log(f"[long] {cfg.name}: one {LONG_S}-token bulk prefill at full "
        f"depth: wall "
        f"{walls[0] * 1e3:.1f} / {wall_ms:.1f} ms (two runs); profiled: "
        f"device busy {busy:.1f} ms ({busy / wall_ms:.1%} of the unprofiled "
        f"wall), flash kernel {flash_ms:.1f} ms in {len(flash)} launches "
        f"({flash_ms / busy:.1%} of busy), SSD kernel {ssd_ms:.1f} ms in "
        f"{len(ssd)} launches ({ssd_ms / busy:.1%} of busy), the rest "
        f"{busy - flash_ms - ssd_ms:.1f} ms in {rest} kernels")
    return {"wall_ms": wall_ms, "busy_ms": busy, "flash_ms": flash_ms,
            "ssd_ms": ssd_ms, "ssd_launches": len(ssd),
            "ssd_share_of_busy": ssd_ms / busy}


def long_prefill_vs_plain(cfg, params, dev, tol):
    """One 16384-token ``make_prefill`` with the kernel and with
    ``impl="ref"`` from the same tokens: the last-position logits."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model_zoo as zoo
    g = torch.Generator(dev).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_S), generator=g,
                         device=dev, dtype=torch.int32)
    shape = ShapeConfig("long", LONG_S, 1, "prefill")
    outs, secs = {}, {}
    for impl in ("kernel", "ref"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = zoo.make_prefill(cfg, shape, impl=impl)(
            params, {"tokens": toks})
        outs[impl] = logits[0, -1, :cfg.vocab_size].float()
        torch.cuda.synchronize()
        secs[impl] = time.perf_counter() - t0
        del logits, state
        torch.cuda.empty_cache()
    a, b = outs["kernel"], outs["ref"]
    assert torch.isfinite(a).all() and a.shape == b.shape
    rel = rel_l2(a, b)
    agree = float(a.argmax() == b.argmax())
    log(f"[long prefill {cfg.name} {cfg.compute_dtype}] {LONG_S} tokens at "
        f"full depth, "
        f"kernel vs plain: rel_l2={rel:.3e} max_abs={max_err(a, b):.3e} "
        f"argmax agreement {agree:.0f} (tol {tol}); {secs['kernel']:.2f} s "
        f"vs {secs['ref']:.2f} s")
    assert rel <= tol["rel_l2"] and agree >= tol["argmax_agree"]


def small_long_parity(dev):
    """Reduced granite-8b, float32, a bucket of 8704: the dense engine
    (the flash kernel in its bulk prefill) and the paged engine give the
    same greedy streams."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serving.engine import ServingEngine
    small = get_config("granite-8b").reduced().with_(compute_dtype="float32")
    sp = zoo.init_serving_params(small, seed=0, device=dev)
    streams, launches = [], {}
    for mode in ("dense", "paged"):
        eng = ServingEngine(small, sp, batch_size=3, max_seq=9216,
                            prefill_buckets=(16, 64, 256, 8704),
                            cache_mode=mode, block_size=16, device=dev)
        rs = requests(small, [8300, 30, 200], 8, seed=13)
        for r in rs:
            eng.submit(r)
        before = fk.launches
        eng.run_until_idle()
        launches[mode] = fk.launches - before
        assert all(r.done and len(r.out_tokens) == 8 for r in rs)
        streams.append([r.out_tokens for r in rs])
    assert launches == {"dense": small.num_layers, "paged": 0}, launches
    assert streams[0] == streams[1], streams
    log(f"[small] reduced granite-8b f32, an 8300-token prompt in the 8704 "
        f"bucket: dense (flash kernel, {launches['dense']} launches) and "
        f"paged engines give identical greedy streams")


# ---------------------------------------------------- work-unit migration
def sync_free_window(engine, what) -> int:
    """One decode window under ``set_sync_debug_mode("error")``: the
    installs of the units waiting in the restore queue, then
    ``decode_block`` fused steps, with no host sync.  Returns its
    steps."""
    import torch
    syncs = engine.host_syncs
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = engine.step_many(engine.decode_block)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out["steps"] == engine.decode_block, (what, out)
    assert engine.host_syncs == syncs, (what, engine.host_syncs, syncs)
    return out["steps"]


def drive(engine) -> int:
    """Run ``engine`` until idle; returns the decode steps it ran."""
    steps = 0
    while engine.n_active or engine.n_queued:
        steps += engine.step_many(engine.decode_block)["steps"]
    return steps


def unit_bytes(unit) -> int:
    return sum(t.nbytes for t in unit.snapshot.cache.values())


def assert_same_columns(units, cols, what):
    """Every unit's columns equal ``cols[rid]`` bit for bit."""
    import torch
    for u in units:
        want = cols[u.rid]
        assert set(u.snapshot.cache) == set(want), what
        for k, t in u.snapshot.cache.items():
            w = want[k]
            assert t.dtype == w.dtype and t.shape == w.shape, (what, k)
            assert torch.equal(t.view(torch.uint8), w.view(torch.uint8)), \
                (what, u.rid, k)


def fresh_units(units, outs):
    """Copies of ``units`` whose requests stand where they stood at the
    pack (``outs``: rid -> tokens then), so one checkpoint can be
    installed into several engines."""
    from repro_torch.serving.workunit import WorkUnit
    return [WorkUnit(snapshot=dataclasses.replace(
        u.snapshot, request=dataclasses.replace(
            u.snapshot.request, out_tokens=list(outs[u.rid]), done=False)),
        uid=u.uid) for u in units]


def first_step_logits(engine, params):
    """The logits of one decode step on a copy of ``engine``'s state,
    by request id (the engine itself does not move)."""
    from repro_torch.models import model_zoo as zoo
    if engine.cache_mode == "paged":
        step = zoo.make_paged_serve_step(engine.cfg, engine.shape,
                                         engine.block_size,
                                         engine.pool_blocks)
    else:
        step = zoo.make_serve_step(engine.cfg, engine.shape)
    logits, _ = step(params, copy.deepcopy(engine.state),
                     engine.sample.next_tok.clone(),
                     engine.sample.active.clone())
    rows = logits[:, -1, :engine.cfg.vocab_size].float()
    return {r.rid: rows[s] for s, r in engine.slot_requests()}


def logits_vs_source(got, ref, tol, what):
    import torch
    rids = sorted(got)
    a = torch.stack([got[r] for r in rids])
    b = torch.stack([ref[r] for r in rids])
    assert torch.isfinite(a).all()
    rel = rel_l2(a, b)
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"  {what}: first step's logits vs the source geometry's, "
        f"{len(rids)} lanes: rel_l2={rel:.3e} max_abs={max_err(a, b):.3e} "
        f"argmax agreement {agree:.3f} (tol {tol})")
    assert rel <= tol["rel_l2"] and agree >= tol["argmax_agree"], what
    return rel


def install_and_repack(units, engine, cols, what):
    """Unpack ``units`` into ``engine``, install them (the admission the
    next ``step_many`` would make), and pack them again before any step:
    every column must come back bit for bit.  Returns the repacked
    units and (install, pack) ms per unit."""
    import torch
    engine.unpack(units)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._admit()         # the admission step_many would make first
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    again = engine.pack()
    t2 = time.perf_counter()
    assert sorted(u.rid for u in again) == sorted(u.rid for u in units)
    assert_same_columns(again, cols, what)
    n = len(units)
    return again, (t1 - t0) * 1e3 / n, (t2 - t1) * 1e3 / n


def migration_path(arch, attn_layers, mamba_layers, dev):
    """Phase 17, same geometry: run A serves the main path's 8 requests
    unmigrated; run B, two decode windows in, packs ``MIGRATE_PACK``
    into a second engine, preempts ``MIGRATE_PREEMPT`` and resumes them
    in place, checkpoints the rest and replays the checkpoint in a third
    engine.  Every stream equals run A's token for token; the window
    after each unpack makes no host sync; the launch counts (zeroed
    just before run B, read just after) are the layers times the decode
    steps (and chunk prefills) of the three engines.  Then the packed
    units install into a fresh engine and pack again bit for bit.
    Returns (launches, numbers, params, run A's streams by rid)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config(arch)
    params = zoo.init_serving_params(cfg, seed=0, device=dev)

    def engine():
        return ServingEngine(cfg, params, batch_size=8, max_seq=1024,
                             block_size=16, cache_mode="paged", device=dev)

    run_a = engine()
    reqs_a = requests(cfg, PROMPT_LENS, 32, seed=0)
    for r in reqs_a:
        run_a.submit(r)
    drive(run_a)
    want = {r.rid: list(r.out_tokens) for r in reqs_a}
    del run_a

    src, dst, rec = engine(), engine(), engine()
    reqs = requests(cfg, PROMPT_LENS, 32, seed=0)
    for r in reqs:
        src.submit(r)
    torch.cuda.synchronize()
    pa.launches = ssd.launches = 0
    steps = sum(src.step_many(src.decode_block)["steps"] for _ in range(2))
    syncs = src.host_syncs
    packed = src.pack(MIGRATE_PACK)
    assert [u.rid for u in packed] == MIGRATE_PACK, [u.rid for u in packed]
    assert src.host_syncs == syncs + 2          # one poll, one fetch
    outs = {u.rid: list(u.snapshot.request.out_tokens) for u in packed}
    dst.unpack(packed)
    steps += sync_free_window(dst, f"{arch}: after unpack")
    paused = src.preempt(MIGRATE_PREEMPT)
    assert [u.rid for u in paused] == MIGRATE_PREEMPT
    src.resume(paused)
    steps += sync_free_window(src, f"{arch}: after resume")
    ckpt = src.checkpoint_units()
    assert sorted(u.rid for u in ckpt) == sorted(
        set(range(8)) - set(MIGRATE_PACK))
    rec.unpack(ckpt)
    steps += drive(src) + drive(dst) + drive(rec)
    torch.cuda.synchronize()
    launches = {"paged_attention": pa.launches,
                "ssd_intra_chunk": ssd.launches}
    prefills = src.chunk_prefills + dst.chunk_prefills + rec.chunk_prefills
    expect = {"paged_attention": attn_layers * steps,
              "ssd_intra_chunk": mamba_layers * prefills}
    assert launches == expect, (launches, expect)
    for r in reqs:
        assert r.done and r.out_tokens == want[r.rid], (arch, r.rid)
    for u in ckpt:
        req = u.snapshot.request
        assert req.done and req.out_tokens == want[u.rid], (arch, u.rid)
    assert (src.preemptions, src.resumes) == (2, 2)
    log(f"[migrate] {arch}: run B (pack {MIGRATE_PACK} into a second "
        f"engine, preempt {MIGRATE_PREEMPT} and resume in place, "
        f"checkpoint the rest and replay it in a third) equals run A token "
        f"for token on all 8 streams and the {len(ckpt)} replays; 0 host "
        f"syncs in the window after the unpack and after the resume; "
        f"launches {launches} = {attn_layers} x {steps} decode steps, "
        f"{mamba_layers} x {prefills} chunk prefills")
    del src, dst, rec
    cols = {u.rid: u.snapshot.cache for u in packed}
    dtypes = {k: str(t.dtype) for k, t in packed[0].snapshot.cache.items()}
    _, install_ms, pack_ms = install_and_repack(
        fresh_units(packed, outs), engine(), cols, f"{arch} same geometry")
    nbytes = unit_bytes(packed[0])
    log(f"  {arch}: {len(packed)} units of {nbytes} B "
        f"({nbytes / 2**20:.1f} MiB, leaves {dtypes}) unpacked into a "
        f"fresh engine and packed again before any step: every column bit "
        f"for bit; install {install_ms:.2f} ms/unit, pack "
        f"{pack_ms:.2f} ms/unit (into new pinned host memory: the first "
        f"units are still held)")
    return launches, {"unit_bytes": nbytes, "install_ms": install_ms,
                      "pack_ms": pack_ms}, params, want


def migrate_all_slots(cfg, params, want, dev):
    """Phase 17 on the moe path: all 8 slots packed two decode windows in
    and unpacked into a fresh engine of the same geometry, whose window
    after the install makes no host sync and whose streams equal run A's
    (``want``).  Returns bytes, pack and install ms per unit."""
    import torch
    from repro_torch.serving.engine import ServingEngine
    geom = dict(batch_size=8, max_seq=1024, block_size=16,
                cache_mode="paged", device=dev)
    src = ServingEngine(cfg, params, **geom)
    for r in requests(cfg, PROMPT_LENS, 32, seed=0):
        src.submit(r)
    for _ in range(2):
        src.step_many(src.decode_block)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    units = src.pack()
    pack_ms = (time.perf_counter() - t0) * 1e3 / len(units)
    assert len(units) == 8
    del src
    dst = ServingEngine(cfg, params, **geom)
    dst.unpack(units)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dst._admit()            # the admission step_many would make first
    torch.cuda.synchronize()
    install_ms = (time.perf_counter() - t0) * 1e3 / len(units)
    sync_free_window(dst, f"{cfg.name}: after unpacking all 8")
    drive(dst)
    for u in units:
        req = u.snapshot.request
        assert req.done and req.out_tokens == want[u.rid], (cfg.name, u.rid)
    nbytes = unit_bytes(units[0])
    log(f"[migrate] {cfg.name}: all 8 slots packed two windows in and "
        f"unpacked into a fresh engine: 8/8 streams equal run A's, 0 host "
        f"syncs in the window after the install; {nbytes} B a unit "
        f"({nbytes / 2**20:.1f} MiB), pack {pack_ms:.2f} ms/unit, install "
        f"{install_ms:.2f} ms/unit")
    return {"unit_bytes": nbytes, "pack_ms": pack_ms,
            "install_ms": install_ms}


def link_yardstick(nbytes, dev, iters=5):
    """Pinned host <-> device copies of ``nbytes``: (D2H ms, H2D ms)."""
    import torch
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = []
    for dst, src in ((host, card), (card, host)):
        dst.copy_(src, non_blocking=True)
        ends = [(torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda.synchronize()
        for s, e in ends:
            s.record()
            dst.copy_(src, non_blocking=True)
            e.record()
        torch.cuda.synchronize()
        out.append(sum(s.elapsed_time(e) for s, e in ends) / iters)
    return tuple(out)


def store_timings(state, dev):
    """The paper's host staging against a device copy: ``InMemoryStore``
    and ``DeviceStore`` save and restore of a full-width decode state,
    twice each (the first pays the allocations), every restore held to
    the saved state bit for bit.  Speed is recorded, not asserted."""
    import torch
    from repro_torch.core.checkpointing import (DeviceStore, InMemoryStore,
                                                tree_leaves)
    out = {}
    for cls in (InMemoryStore, DeviceStore):
        for rnd in range(2):
            store = cls()
            save_s = store.save("state", state)
            back = store.restore("state", device=dev)
            restore_s = store.timer.stages["restore"]
            for a, b in zip(tree_leaves(back), tree_leaves(state)):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            nbytes = store.nbytes("state")
            out[f"{cls.__name__} {rnd}"] = (save_s * 1e3, restore_s * 1e3)
            log(f"  {cls.__name__} round {rnd}: {nbytes} B, save "
                f"{save_s * 1e3:.2f} ms ({nbytes / save_s / 1e9:.2f} GB/s), "
                f"restore {restore_s * 1e3:.2f} ms "
                f"({nbytes / restore_s / 1e9:.2f} GB/s), restored bit for bit")
            del back
            store.drop("state")
    return out


def migration_geometry(params, want, dev):
    """Phase 17, geometry changes on full-width granite-8b: all 8 slots
    packed two windows in (timed, with the link's yardstick and the
    stores beside it), then installed into a dense engine, a 32-position
    block engine and an engine resized 8 -> 4 -> 8 lanes.  Each install
    packs again before any step bit for bit; each first decode step's
    logits are held to the source geometry's (``MIGRATE_LOGITS_TOL``);
    whether the streams still equal run A's (``want``) is logged."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("granite-8b")
    geom = dict(batch_size=8, max_seq=1024, block_size=16,
                cache_mode="paged", device=dev)
    src = ServingEngine(cfg, params, **geom)
    for r in requests(cfg, PROMPT_LENS, 32, seed=0):
        src.submit(r)
    for _ in range(2):
        src.step_many(src.decode_block)
    ref = first_step_logits(src, params)
    log("[migrate] stores: the full-width granite-8b decode state "
        f"({sum(t.nbytes for t in src.state.cache.values())} B of cache)")
    stores = store_timings(src.state, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    units = src.pack()
    pack_ms = (time.perf_counter() - t0) * 1e3 / len(units)
    del src
    nbytes = unit_bytes(units[0])
    d2h_ms, h2d_ms = link_yardstick(nbytes, dev)
    log(f"[migrate] granite-8b: pack of all 8 slots {pack_ms:.2f} ms/unit "
        f"({nbytes} B a unit, into pinned host blocks the store rounds "
        f"left cached); "
        f"pinned copies of the same bytes: D2H {d2h_ms:.3f} ms "
        f"({nbytes / d2h_ms / 1e6:.2f} GB/s), H2D {h2d_ms:.3f} ms "
        f"({nbytes / h2d_ms / 1e6:.2f} GB/s)")
    outs = {u.rid: list(u.snapshot.request.out_tokens) for u in units}
    cols = {u.rid: u.snapshot.cache for u in units}
    numbers = {"unit_bytes": nbytes, "first_pack_ms": pack_ms,
               "d2h_ms": d2h_ms, "h2d_ms": h2d_ms, "stores": stores}

    for what, kw in (("dense", dict(cache_mode="dense")),
                     ("block 32", dict(block_size=32))):
        moved = fresh_units(units, outs)
        tgt = ServingEngine(cfg, params, **dict(geom, **kw))
        again, install_ms, repack_ms = install_and_repack(
            moved, tgt, cols, what)
        tgt.unpack(again)
        tgt._admit()
        rel = logits_vs_source(first_step_logits(tgt, params), ref,
                               MIGRATE_LOGITS_TOL, what)
        drive(tgt)
        same = sum(u.snapshot.request.out_tokens == want[u.rid]
                   for u in moved)
        log(f"  {what}: every column bit for bit after install + pack; "
            f"install {install_ms:.2f} ms/unit, pack {repack_ms:.2f} "
            f"ms/unit (new pinned host memory); {same}/8 streams equal "
            f"run A's")
        numbers[what] = {"install_ms": install_ms, "pack_ms": repack_ms,
                         "logits_rel_l2": rel, "streams_equal": same}
        del tgt

    moved = fresh_units(units, outs)
    tgt = ServingEngine(cfg, params, **geom)
    tgt.unpack(moved)
    tgt._admit()
    evicted = tgt.resize(batch_size=4)
    assert len(evicted) == 4 and tgt.n_active == 4 and tgt.batch == 4
    assert_same_columns(evicted, cols, "resize 8 -> 4, evicted")
    rel4 = logits_vs_source(first_step_logits(tgt, params), ref,
                            MIGRATE_LOGITS_TOL, "resize to 4 lanes")
    kept = tgt.pack()
    assert_same_columns(kept, cols, "resize 8 -> 4, kept")
    assert tgt.resize(batch_size=8) == [] and tgt.batch == 8
    tgt.unpack(kept)
    tgt.resume(evicted)
    tgt._admit()
    rel8 = logits_vs_source(first_step_logits(tgt, params), ref,
                            MIGRATE_LOGITS_TOL, "resized back to 8 lanes")
    drive(tgt)
    same = sum(u.snapshot.request.out_tokens == want[u.rid] for u in moved)
    log(f"  resize 8 -> 4 -> 8: 4 evicted, every column bit for bit after "
        f"each resize; {same}/8 streams equal run A's")
    numbers["resize"] = {"logits_rel_l2_4": rel4, "logits_rel_l2_8": rel8,
                         "streams_equal": same}
    return numbers


def migration_phase(dev):
    """Phase 17: work-unit migration on the card.  Returns the launches
    of each same-geometry run B by path, and the phase's numbers."""
    import torch
    from repro_torch.configs import get_config
    by_path, numbers = {}, {}
    for arch, attn_layers, mamba_layers in MIGRATE_PATHS:
        launches, numbers[arch], params, want = migration_path(
            arch, attn_layers, mamba_layers, dev)
        by_path[f"{arch} migration"] = launches
        if arch == "granite-8b":
            numbers["geometry"] = migration_geometry(params, want, dev)
        if get_config(arch).family == "moe":
            numbers[arch]["all slots"] = migrate_all_slots(
                get_config(arch), params, want, dev)
        del params
        torch.cuda.empty_cache()
    return by_path, numbers


# ------------------------------------------------------ the serving cluster
def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def release(dev):
    """Free what a finished cluster run held: its event loop's handlers
    are bound methods of the cluster, a reference cycle that only the
    cyclic collector breaks, so the engines' pools outlive ``del``."""
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


@contextlib.contextmanager
def cluster_probes(dev):
    """Class-level wrappers that measure one cluster run: the decode steps
    every engine ran, each install's host ms and device ms (CUDA events,
    no sync) by where its columns lay, each pack's (drains and moves) and
    checkpoint's ms, and each endpoint round trip's kind, unit bytes and
    stage seconds.  Restored on exit."""
    import torch
    from repro_torch.cluster.endpoint import MigrationEndpoint
    from repro_torch.serving.engine import ServingEngine
    rec = {"steps": 0, "installs": [], "stages": [], "packs": []}
    step_many = ServingEngine.step_many
    install = ServingEngine._install
    roundtrip = MigrationEndpoint.roundtrip
    packs = {verb: getattr(ServingEngine, verb)
             for verb in ("pack", "checkpoint_units")}

    def timed(verb):
        def run(self, *a, **kw):
            t0 = time.perf_counter()
            units = packs[verb](self, *a, **kw)
            if units:
                rec["packs"].append((verb, len(units),
                                     (time.perf_counter() - t0) * 1e3))
            return units
        return run

    def counted_step_many(self, n_steps):
        out = step_many(self, n_steps)
        rec["steps"] += out["steps"]
        return out

    def timed_install(self, snap, slot):
        where = next(iter(snap.cache.values())).device.type
        ev = None
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        install(self, snap, slot)
        host_ms = (time.perf_counter() - t0) * 1e3
        if ev is not None:
            ev[1].record()
        rec["installs"].append((where, host_ms, ev))

    def staged(self, units, name):
        out = roundtrip(self, units, name)
        rec["stages"].append((self.kind, [unit_bytes(u) for u in units],
                              out))
        return out

    ServingEngine.step_many = counted_step_many
    ServingEngine._install = timed_install
    MigrationEndpoint.roundtrip = staged
    for verb in packs:
        setattr(ServingEngine, verb, timed(verb))
    try:
        yield rec
    finally:
        for verb, fn in packs.items():
            setattr(ServingEngine, verb, fn)
        ServingEngine.step_many = step_many
        ServingEngine._install = install
        MigrationEndpoint.roundtrip = roundtrip


def peak_gib() -> float:
    """``torch.cuda.max_memory_allocated`` since the last ``release``."""
    import torch
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 2**30


def pinned_stats() -> dict:
    """The caching pinned-host allocator's counts (new page-locked
    allocations against requests served from freed blocks), where this
    torch reports them."""
    import torch
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return {}
    return {k: v for k, v in stats().items()
            if isinstance(v, int) and ("alloc" in k or "free" in k)}


def install_times(rec) -> dict:
    """Installs by where their columns lay: count, mean host ms and mean
    device ms (read after the run's last sync)."""
    out = {}
    for where, host_ms, ev in rec["installs"]:
        row = out.setdefault(where, {"installs": 0, "host_ms": [],
                                     "device_ms": []})
        row["installs"] += 1
        row["host_ms"].append(host_ms)
        if ev is not None:
            row["device_ms"].append(ev[0].elapsed_time(ev[1]))
    for row in out.values():
        for k in ("host_ms", "device_ms"):
            row[k] = sum(row[k]) / len(row[k]) if row[k] else None
    return out


def cluster_engine():
    import functools
    from repro_torch.serving.engine import ServingEngine
    return functools.partial(ServingEngine, cache_mode="paged",
                             block_size=16)


def lone_engine_streams(cfg, params, dev, reqs, geometry) -> dict:
    """``reqs`` through one paged engine of ``geometry``: the streams a
    fleet of such replicas must give."""
    eng = cluster_engine()(cfg, params, device=dev, **geometry)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert all(r.done and len(r.out_tokens) == r.max_new_tokens
               for r in reqs)
    return {r.rid: list(r.out_tokens) for r in reqs}


def check_served(what, reqs, out, probe, launches, want, dev):
    """Everyone served with their token counts (and ``want``'s streams,
    unless it is None); the paged kernel launched 36 x the decode steps
    summed over the replicas."""
    assert out["completed"] == out["submitted"] == len(reqs), (what, out)
    assert out["dropped"] == 0, (what, out)
    for r in reqs:
        assert r.done and len(r.out_tokens) == r.max_new_tokens, \
            (what, r.rid)
        assert want is None or r.out_tokens == want[r.rid], \
            (what, r.rid, r.out_tokens, want[r.rid])
    if dev.type == "cuda":
        assert launches == CLUSTER_ATTN_LAYERS * probe["steps"], \
            (what, launches, probe["steps"])


def cluster_run(cfg, params, dev, chaos=False):
    """One fleet run through ``ServingCluster``: the spot interruptions of
    ``CLUSTER_INTERRUPTS``, or (``chaos``) the seeded soup plus
    ``CLUSTER_KILL`` with checkpoints, the failure detector and the
    straggler policy.  The paged launch count is set to 0 just before
    the run and read just after.  Returns (cluster, requests, summary,
    wall s, probes, launches)."""
    from repro_torch.cluster import (CheckpointPolicy, FailureDetector,
                                     InstanceType, RateAwareRouter,
                                     ServingCluster, StragglerPolicy)
    from repro_torch.runtime import FaultTrace
    from repro_torch.serving.workload import BatchArrivals
    fleet = [InstanceType(name, speed, accelerator=acc)
             for name, speed, acc in CLUSTER_FLEET]
    kw = {}
    if chaos:
        trace = FaultTrace.chaos_sampled(
            targets=len(fleet), rebalance_lead=6.0, notice_deadline=4.0,
            **CLUSTER_CHAOS)
        trace.inject_hard_kill(*CLUSTER_KILL)
        kw = dict(checkpoint=CheckpointPolicy(interval=CLUSTER_CKPT_S),
                  health=FailureDetector(),
                  straggler=StragglerPolicy())
    else:
        trace = FaultTrace(rebalance_lead=6.0, notice_deadline=4.0)
        for t, rid in CLUSTER_INTERRUPTS:
            trace.inject(t, rid)
    cl = ServingCluster(cfg, params, fleet, router=RateAwareRouter(),
                        engine=cluster_engine(), dt=1.0, seed=0,
                        trace=trace, device=dev, **CLUSTER_GEOMETRY, **kw)
    reqs = requests(cfg, CLUSTER_LENS, 32, seed=0)
    cl.attach_arrivals(BatchArrivals(reqs))
    return (cl, reqs) + counted_run(cl.run, dev)


def counted_run(run, dev):
    """``run()`` under ``cluster_probes``, the paged launch count set to 0
    just before it and read just after.  Returns (its result, wall s,
    probes, launches)."""
    from repro_torch.kernels.paged_attention import kernel as pa
    with cluster_probes(dev) as probe:
        sync(dev)
        pa.launches = 0
        t0 = time.perf_counter()
        out = run()
        sync(dev)
        wall = time.perf_counter() - t0
        launches = pa.launches
    return out, wall, probe, launches


def log_cluster_run(what, cl, out, wall, probe, launches):
    log(f"  {what}: {out['completed']}/{out['submitted']} served, "
        f"{out['total_tokens']} tokens in {wall:.2f} s wall "
        f"({out['total_tokens'] / wall:.1f} tok/s across the fleet); "
        f"virtual makespan {out['virtual_seconds']:.1f} s, p50 "
        f"{out['p50_latency']:.1f} s, p99 {out['p99_latency']:.1f} s; "
        f"paged launches {launches} = {CLUSTER_ATTN_LAYERS} x "
        f"{probe['steps']} decode steps summed over "
        f"{len(cl.replicas)} replicas")
    for rep in cl.replicas:
        log(f"    r{rep.rid} {rep.itype.name} ({rep.endpoint.kind} "
            f"endpoint, {rep.state.value}): {rep.tokens_total} tokens, "
            f"host_syncs {rep.engine.host_syncs}")
    for d in cl.metrics.drains:
        log(f"    drain r{d.replica} at t={d.t:.1f} through the "
            f"{d.endpoint} endpoint: {d.slots_migrated} slots, "
            f"{d.queued_requeued} queued requeued, checkpoint "
            f"{d.checkpoint_s * 1e3:.2f} ms, restore "
            f"{d.restore_s * 1e3:.2f} ms")
    for kind, nbytes, (ck, rs) in probe["stages"]:
        if nbytes:
            log(f"    {kind} stage: {len(nbytes)} units of "
                f"{nbytes[0]} B, checkpoint {ck * 1e3 / len(nbytes):.2f} "
                f"ms/unit, restore {rs * 1e3 / len(nbytes):.2f} ms/unit")
    for where, row in install_times(probe).items():
        dev_ms = ("n/a" if row["device_ms"] is None
                  else f"{row['device_ms']:.2f}")
        log(f"    installs from {where} columns: {row['installs']}, "
            f"host {row['host_ms']:.2f} ms, device {dev_ms} ms each")
    for verb in ("pack", "checkpoint_units"):
        ms = [t / n for v, n, t in probe["packs"] if v == verb]
        if ms:
            half = max(len(ms) // 2, 1)
            log(f"    {verb}: {len(ms)} calls, "
                f"{sum(n for v, n, _ in probe['packs'] if v == verb)} "
                f"units, ms/unit first half {spread(ms[:half], 1)}, "
                f"second half {spread(ms[half:] or ms[:half], 1)}")
    log(f"    peak memory allocated in the run {peak_gib():.2f} GiB; "
        f"pinned host allocator (process totals) {pinned_stats()}")


def endpoint_install_check(cfg, params, dev, want) -> dict:
    """Two slots packed two windows in, one staged through a
    ``DeviceEndpoint`` (its columns come back on the card) and one
    through a ``HostEndpoint`` (unpinned host copies), unpacked into an
    engine that is decoding: the window that installs them makes no host
    sync, and both streams equal the lone engine's.  Returns the install
    ms by endpoint kind."""
    from repro_torch.cluster import DeviceEndpoint, HostEndpoint
    from repro_torch.serving.engine import ServingEngine
    make = cluster_engine()
    src = make(cfg, params, device=dev, **CLUSTER_GEOMETRY)
    dst = make(cfg, params, device=dev, **CLUSTER_GEOMETRY)
    reqs = requests(cfg, CLUSTER_LENS[:8], 32, seed=0)
    for r in reqs:
        src.submit(r)
    for r in requests(cfg, [20] * 4, 64, seed=1, start=100):
        dst.submit(r)
    for eng in (src, dst):
        eng.step_many(eng.decode_block)
        eng.step_many(eng.decode_block)
    d_unit, h_unit = src.pack([1, 4])
    ck = {}
    for kind, ep, u in (("device", DeviceEndpoint(device=dev), d_unit),
                        ("host", HostEndpoint(device=dev), h_unit)):
        ck[kind] = ep.roundtrip([u], f"check_{kind}")
        cols = u.snapshot.cache.values()
        where = {t.device.type for t in cols}
        assert u.residency == kind
        assert where == ({dev.type} if kind == "device" else {"cpu"}), where
        if kind == "host":
            assert not any(t.is_pinned() for t in cols)
    dst.unpack([d_unit, h_unit])
    with cluster_probes(dev) as probe:
        if dev.type == "cuda":
            sync_free_window(dst, "after the endpoint installs")
        else:
            dst.step_many(dst.decode_block)
        sync(dev)
    times = {("host" if w == "cpu" else "device"): row
             for w, row in install_times(probe).items()}
    for eng in (src, dst):
        drive(eng)
    for r in reqs:
        assert r.done and r.out_tokens == want[r.rid], r.rid
    for kind, (c, rs) in ck.items():
        row = times.get(kind, {})
        log(f"  {kind} endpoint: a {unit_bytes(d_unit)} B unit staged in "
            f"{c * 1e3:.2f} + {rs * 1e3:.2f} ms (checkpoint + restore); "
            f"its install {row.get('host_ms', float('nan')):.2f} ms host, "
            f"{row.get('device_ms') or float('nan'):.2f} ms device")
    log("  the window that installs both makes 0 host syncs; both "
        "streams equal the lone engine's")
    return {k: dict(v, checkpoint_ms=ck[k][0] * 1e3,
                    restore_ms=ck[k][1] * 1e3) for k, v in times.items()}


def cluster_phase(cfg, params, dev):
    """Phase 18 up to the launcher: the serving cluster on the card.
    Returns the paged launches of each run by path, and the phase's
    numbers."""
    t_phase = time.perf_counter()
    want = lone_engine_streams(cfg, params, dev,
                               requests(cfg, CLUSTER_LENS, 32, seed=0),
                               CLUSTER_GEOMETRY)
    release(dev)
    log(f"[cluster] {CLUSTER_ARCH} at full width and depth, paged "
        f"replicas {CLUSTER_GEOMETRY}, fleet {CLUSTER_FLEET}, "
        f"{len(CLUSTER_LENS)} requests of {min(CLUSTER_LENS)}-"
        f"{max(CLUSTER_LENS)} prompt tokens x 32 new, spot interruptions "
        f"{CLUSTER_INTERRUPTS}")
    by_path, numbers, repeat = {}, {}, []
    for run in range(2):
        cl, reqs, out, wall, probe, launches = cluster_run(cfg, params, dev)
        check_served("fleet", reqs, out, probe, launches, want, dev)
        drains = cl.metrics.drains
        assert out["drains"] == len(CLUSTER_INTERRUPTS), out["drains"]
        assert all(d.slots_migrated >= 1 for d in drains), drains
        assert sorted(d.endpoint for d in drains) == ["device", "host"]
        repeat.append((cl.loop.journal_digest, cl.loop.dispatched,
                       {k: v for k, v in out.items()
                        if k not in CLUSTER_WALL_KEYS}))
        if run == 0:
            log_cluster_run("fleet run 1", cl, out, wall, probe, launches)
            by_path[f"{CLUSTER_ARCH} cluster"] = {
                "paged_attention": launches, "ssd_intra_chunk": 0}
            numbers["fleet"] = {
                "wall_s": wall, "tok_per_wall_s": out["total_tokens"] / wall,
                "virtual_s": out["virtual_seconds"],
                "p50_s": out["p50_latency"], "p99_s": out["p99_latency"],
                "drains": [(d.endpoint, d.slots_migrated,
                            d.checkpoint_s * 1e3, d.restore_s * 1e3)
                           for d in drains],
                "unit_bytes": next(b[0] for _, b, _ in probe["stages"]
                                   if b),
                "installs": install_times(probe),
                "host_syncs": {r.rid: r.engine.host_syncs
                               for r in cl.replicas},
                "packs": probe["packs"]}
        else:
            log(f"  fleet run 2: {wall:.2f} s wall, launches {launches}")
        numbers.setdefault("peak_gib", []).append(peak_gib())
        del cl, reqs, probe
        release(dev)
    assert repeat[0] == repeat[1], "the repeated run moved"
    log(f"  the repeated run gives the same journal digest "
        f"({repeat[0][0]}, {repeat[0][1]} events) and the same summary "
        f"(the {len(CLUSTER_WALL_KEYS)} wall-clock keys left out); every "
        f"stream equals the lone paged engine's")
    numbers["endpoint_installs"] = endpoint_install_check(cfg, params, dev,
                                                          want)
    release(dev)

    cl, reqs, out, wall, probe, launches = cluster_run(cfg, params, dev,
                                                      chaos=True)
    check_served("chaos", reqs, out, probe, launches, want, dev)
    assert out["hard_kills"] >= 1 and out["checkpoints"] >= 1, out
    assert out["requests_recovered"] >= 1, out
    from_ckpt = sum(int(m.split(": ")[1].split()[0]) for _, m in cl.timeline
                    if m.startswith("recover "))
    assert from_ckpt >= 1, [m for _, m in cl.timeline if "recover" in m]
    log(f"  chaos (soup {CLUSTER_CHAOS} plus a hard kill {CLUSTER_KILL}): "
        f"hard_kills {out['hard_kills']}, checkpoints "
        f"{out['checkpoints']} ({out['checkpointed_units']} units, "
        f"{out['checkpoint_stage_s'] * 1e3:.1f} ms), recovered "
        f"{out['requests_recovered']} ({from_ckpt} units from a "
        f"checkpoint), replayed {out['replayed_tokens']} "
        f"tokens, restore {out['recovery_restore_s'] * 1e3:.1f} ms, "
        f"slowdowns {out['slowdowns']}, contention windows "
        f"{out['contention_windows']}, endpoint faults "
        f"{out['endpoint_faults']} ({out['endpoint_retries']} retries), "
        f"quarantines {out['quarantines']}; every stream equals the lone "
        f"engine's")
    log_cluster_run("chaos run", cl, out, wall, probe, launches)
    by_path[f"{CLUSTER_ARCH} cluster chaos"] = {
        "paged_attention": launches, "ssd_intra_chunk": 0}
    numbers["chaos"] = {k: out[k] for k in (
        "hard_kills", "checkpoints", "requests_recovered",
        "replayed_tokens", "virtual_seconds")}
    numbers["chaos"].update(wall_s=wall, units_from_checkpoint=from_ckpt,
                            packs=probe["packs"], pinned=pinned_stats())
    numbers["peak_gib"].append(peak_gib())
    del cl, reqs, probe
    release(dev)
    numbers["phase_s"] = time.perf_counter() - t_phase
    log(f"[cluster] phase 18's fleet and chaos runs in "
        f"{numbers['phase_s']:.1f} s")
    return by_path, numbers


def launcher_run(what, flags, dev, arch=CLUSTER_ARCH,
                 attn_layers=CLUSTER_ATTN_LAYERS):
    """``repro_torch.launch.serve.main`` in cluster mode at full width
    (its own weights, drawn from seed 0), the paged launch count set to 0
    just before and read just after: every request served, the paged
    kernel launched ``attn_layers`` x the decode steps.  Returns
    (launches, summary, wall s, peak GiB)."""
    from repro_torch.launch import serve
    argv = ["--arch", arch] + CLUSTER_CLI + flags + (
        [] if dev.type == "cuda" else ["--device", "cpu", "--reduced"])
    log(f"[cluster] {what}: repro_torch.launch.serve.main({argv})")
    with resize_probe(dev) as resizes:
        (cl, reqs, out), wall, probe, launches = counted_run(
            lambda: serve.main(argv), dev)
    assert out["completed"] == out["submitted"] == len(reqs) == 16, out
    assert out["dropped"] == 0 and all(r.done for r in reqs), out
    assert out["resumes"] >= out["vertical_evictions"], out
    check_evictions(resizes)
    if dev.type == "cuda":
        assert launches == attn_layers * probe["steps"], launches
    log(f"  the launcher served {out['completed']}/{out['submitted']} on "
        f"{cl.device} in {wall:.2f} s (the weights drawn included), paged "
        f"launches {launches} = {attn_layers} x {probe['steps']}; "
        f"{len(resizes)} in-place resizes, evictions "
        f"{out['vertical_evictions']}")
    peak = peak_gib()
    del cl, reqs
    release(dev)
    return launches, out, wall, peak


def single_launcher_run(arch, attn_layers, dev):
    """``repro_torch.launch.serve.main`` for one paged engine at full
    width (8 requests, 32 new tokens each), the paged launch count set
    to 0 just before and read just after: its report says every request
    was served, and the paged kernel ran ``attn_layers`` x the decode
    steps.  Returns the launches."""
    import io
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--no-reduced", "--cache-mode", "paged",
            "--batch-size", "8", "--max-seq", "1024", "--requests", "8",
            "--max-new", "32"] + ([] if dev.type == "cuda" else
                                  ["--device", "cpu", "--reduced"])
    log(f"[launcher] repro_torch.launch.serve.main({argv})")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        _, wall, probe, launches = counted_run(lambda: serve.main(argv), dev)
    report = text.getvalue().strip()
    assert f"arch={arch} cache=paged" in report, report
    assert "served 8/8 requests" in report, report
    if dev.type == "cuda":
        assert launches == attn_layers * probe["steps"], launches
    log(f"  {report}; wall {wall:.2f} s (the weights drawn included), "
        f"paged launches {launches} = {attn_layers} x {probe['steps']}")
    release(dev)
    return launches


def market_requests(cfg):
    from repro_torch.serving.workload import SLOClass, classed_requests
    return classed_requests(
        MARKET_REQUESTS, cfg.vocab_size, interactive_frac=0.5, seed=0,
        interactive=SLOClass("interactive", 0, deadline=15.0),
        batch=SLOClass("batch", 2, deadline=500.0, admit_lazily=True))


def market_run(cfg, params, dev, mode, geometry):
    """One ``cluster_spot_market`` run through ``ServingCluster(market=)``
    with the exchange shopping in ``mode``.  Returns (cluster, requests,
    summary, wall s, probes, launches)."""
    from repro_torch.cluster import (DeadlineAwareRouter, InstanceType,
                                     ServingCluster)
    from repro_torch.market import MarketCatalog, SpotExchange, SpotMarket
    from repro_torch.serving.workload import PoissonArrivals
    fleet = [InstanceType("std.1x", 1.0, cost_per_hour=1.0)
             for _ in range(MARKET_REPLICAS)]
    cat = MarketCatalog()
    for name, base, vol, spikes, ir, power, seed in MARKET_MARKETS:
        cat.add_market(SpotMarket(name, base_rate=base, volatility=vol,
                                  spikes=spikes, interruptions_per_hour=ir,
                                  price_power=power, seed=seed))
    for it in set(fleet):
        cat.list_instance(it, markets=tuple(m[0] for m in MARKET_MARKETS))
    exchange = SpotExchange(cat, seed=0, mode=mode, sample_until=500.0)
    cl = ServingCluster(
        cfg, params, fleet, router=DeadlineAwareRouter(),
        engine=cluster_engine(), dt=1.0, seed=0, admission="priority",
        batch_admit_headroom=24.0, rebalance_lead=6.0, notice_deadline=4.0,
        market=exchange, fallback="different_market",
        autoscaler_kw=dict(replacement_latency=10.0,
                           scale_up_backlog=100_000.0,
                           scale_down_idle=10_000.0),
        device=dev, **geometry)
    reqs = market_requests(cfg)
    cl.attach_arrivals(PoissonArrivals(reqs, MARKET_RATE, seed=0))
    return (cl, reqs) + counted_run(cl.run, dev)


def log_market(cl, out):
    """Per-market purchases, dollars and interruptions, the exchange's
    overhead estimate, and each buy beside both markets' effective prices
    at its time (under the run's final overhead estimate)."""
    ex = cl.exchange
    log(f"    market dollars {out['market_dollar_cost']:.6f} against "
        f"{out['on_demand_dollar_cost']:.6f} on demand: savings "
        f"{out['savings_pct']:.3f}%, {out['spot_interruptions']} spot "
        f"interruptions, interactive attainment "
        f"{out['attainment_interactive']:.3f}; estimated_overhead_s "
        f"{ex.estimated_overhead_s():.6f}")
    for m in ex.catalog.markets():
        log(f"    {m.name}: {out[f'market_{m.name}_purchases']} purchases, "
            f"${out[f'market_{m.name}_dollars']:.6f}, "
            f"{out[f'market_{m.name}_interruptions']} interruptions")
    for rec in ex.ledger.purchases:
        it = ex.catalog.listing(rec.itype).itype
        prices = {m.name: ex.effective_price(it, m.name, rec.t_buy)
                  for m in ex.catalog.markets()}
        log(f"    buy r{rec.rid} at t={rec.t_buy:.2f} ({rec.strategy}) @ "
            f"{rec.market}; effective $/h "
            + ", ".join(f"{k} {v:.6f}" for k, v in prices.items()))


def market_phase(cfg, params, dev, geometry):
    """Phase 19 (a): the market A/B, naive once and adjusted twice.
    Returns the paged launches by run and the numbers."""
    log(f"[market] {cfg.name} paged replicas {geometry}, "
        f"{MARKET_REPLICAS} x std.1x on {[m[0] for m in MARKET_MARKETS]}, "
        f"{MARKET_REQUESTS} classed requests at Poisson {MARKET_RATE}/s")
    want = lone_engine_streams(cfg, params, dev, market_requests(cfg),
                               geometry)
    release(dev)
    by_path, numbers, seen = {}, {}, {}
    for tag, mode in MARKET_RUNS:
        cl, reqs, out, wall, probe, launches = market_run(
            cfg, params, dev, mode, geometry)
        check_served(f"market {tag}", reqs, out, probe, launches, want, dev)
        drains = cl.metrics.drains
        assert all(d.slots_migrated >= 1 for d in drains), drains
        if mode == "naive":
            assert out["spot_interruptions"] > 0 and drains, out
        log_cluster_run(f"market {tag}", cl, out, wall, probe, launches)
        log_market(cl, out)
        by_path[f"{CLUSTER_ARCH} market {tag}"] = {
            "paged_attention": launches, "ssd_intra_chunk": 0}
        seen[tag] = (cl.loop.journal_digest, cl.loop.dispatched,
                     {k: v for k, v in out.items()
                      if k not in CLUSTER_WALL_KEYS})
        numbers[tag] = {
            "wall_s": wall, "virtual_s": out["virtual_seconds"],
            "savings_pct": out["savings_pct"],
            "market_dollars": out["market_dollar_cost"],
            "on_demand_dollars": out["on_demand_dollar_cost"],
            "interruptions": out["spot_interruptions"],
            "attainment_interactive": out["attainment_interactive"],
            "estimated_overhead_s": cl.exchange.estimated_overhead_s(),
            "drains": [(d.endpoint, d.slots_migrated, d.checkpoint_s * 1e3,
                        d.restore_s * 1e3) for d in drains],
            "installs": install_times(probe), "peak_gib": peak_gib()}
        del cl, reqs, probe
        release(dev)
    assert seen["adjusted"] == seen["adjusted again"], \
        "the repeated adjusted run moved"
    naive, adjusted = seen["naive"][2], seen["adjusted"][2]
    assert adjusted["savings_pct"] > naive["savings_pct"], (adjusted, naive)
    assert adjusted["attainment_interactive"] \
        >= naive["attainment_interactive"], (adjusted, naive)
    log(f"  adjusted saves {adjusted['savings_pct']:.3f}% against naive's "
        f"{naive['savings_pct']:.3f}% at interactive attainment "
        f"{adjusted['attainment_interactive']:.3f} against "
        f"{naive['attainment_interactive']:.3f}; the repeated adjusted run "
        f"gives the same journal digest ({seen['adjusted'][0]}, "
        f"{seen['adjusted'][1]} events) and summary; every stream equals "
        f"the lone paged engine's")
    return by_path, numbers


def vertical_requests(cfg):
    """``cluster_vertical``'s arrivals: (t, request)."""
    import numpy as np
    from repro_torch.serving.engine import Request
    from repro_torch.serving.workload import SLOClass
    interactive = SLOClass("interactive", 0, deadline=26.0)
    batch = SLOClass("batch", 2, deadline=4000.0, admit_lazily=True)
    rng = np.random.default_rng(11)
    out = []
    for rid in range(VERTICAL_BATCH + VERTICAL_SURGE):
        surge = rid >= VERTICAL_BATCH
        plen = rng.integers(3, 6) if surge else rng.integers(6, 10)
        prompt = rng.integers(0, cfg.vocab_size, int(plen), dtype=np.int32)
        new = rng.integers(4, 7) if surge else rng.integers(28, 36)
        out.append((VERTICAL_SURGE_T if surge else 0.0, Request(
            rid=rid, prompt=prompt, max_new_tokens=int(new),
            slo=interactive if surge else batch)))
    return out


@contextlib.contextmanager
def resize_probe(dev):
    """Wraps ``ServingEngine.resize``: each in-place resize's lanes and
    pool blocks before and after, its device ms (CUDA events), and the QoS
    ranks of the units it evicted and of the slots it kept."""
    import torch
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.vertical import qos_for
    rec = []
    resize = ServingEngine.resize

    def timed(self, **kw):
        before = (self.batch, self.pool_blocks)
        ev = None
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        evicted = resize(self, **kw)
        if ev is not None:
            ev[1].record()
        rec.append(dict(
            lanes=(before[0], self.batch), pool=(before[1], self.pool_blocks),
            ev=ev, evicted=[qos_for(u.slo).eviction_rank for u in evicted],
            kept=[qos_for(r.slo).eviction_rank
                  for _, r in self.slot_requests()]))
        return evicted

    ServingEngine.resize = timed
    try:
        yield rec
    finally:
        ServingEngine.resize = resize


def device_ms(ev) -> float:
    """The device ms between a pair of recorded CUDA events (nan on the
    CPU, where none are recorded)."""
    return float("nan") if ev is None else ev[0].elapsed_time(ev[1])


def check_evictions(resizes):
    """Every unit a resize evicted ranks at or after (QoS: BestEffort
    first) every slot it kept."""
    for rz in resizes:
        if rz["evicted"]:
            assert min(rz["evicted"]) >= max(rz["kept"], default=0), rz


def vertical_run(cfg, params, dev, vertical: bool, geometry):
    """One arm of ``cluster_vertical``: a pinned fleet resized in place by
    ``FixedThresholdVertical`` + ``QoSPolicy``, or the horizontal arm.
    Returns (cluster, requests, summary, wall s, probes, launches,
    resizes)."""
    from repro_torch.cluster import (DeadlineAwareRouter, InstanceType,
                                     ServingCluster)
    from repro_torch.vertical import FixedThresholdVertical, QoSPolicy
    base, top = VERTICAL_LANES
    fleet = [InstanceType("std.1x", 1.0, spot=False, cost_per_hour=1.0)
             for _ in range(2)]
    if vertical:
        qos = QoSPolicy()
        kw = dict(vertical=FixedThresholdVertical(
                      min_batch=base, max_batch=top, step=top - base,
                      grow_backlog=12.0, shrink_backlog=3.0, cooldown=4.0,
                      qos=qos),
                  qos=qos,
                  autoscaler_kw=dict(scale_up_backlog=1e9,
                                     slo_scale_up=False,
                                     max_replicas=len(fleet)))
    else:
        kw = dict(autoscaler_kw=dict(scale_up_backlog=12.0 * base,
                                     scale_up_patience=2.0,
                                     replacement_latency=12.0,
                                     max_replicas=len(fleet) + 2,
                                     scale_down_idle=20.0,
                                     slo_scale_up=True))
    cl = ServingCluster(cfg, params, fleet, router=DeadlineAwareRouter(),
                        engine=cluster_engine(), dt=1.0, seed=0,
                        admission="priority", device=dev,
                        **dict(geometry, batch_size=base), **kw)
    timed = vertical_requests(cfg)
    for at, r in timed:
        cl.submit(r, at=at)
    with resize_probe(dev) as resizes:
        out, wall, probe, launches = counted_run(cl.run, dev)
    return cl, [r for _, r in timed], out, wall, probe, launches, resizes


def qos_shrink_check(cfg, params, dev, geometry):
    """One paged engine of ``geometry``'s 8 lanes holding 4 interactive
    (Guaranteed) and 4 batch-class (BestEffort) streams of the main
    path's prompts, two windows in, shrunk to 4 lanes under
    ``QoSPolicy.evict_key``: the 4 BestEffort units are evicted, the
    Guaranteed ones kept; grown back to 8 lanes, the evicted units
    resume and every stream runs to its 32 tokens, equal to a lone
    engine's.  Returns the shrink's and grow's lanes, pool blocks and
    device ms."""
    from repro_torch.serving.workload import BATCH, INTERACTIVE
    from repro_torch.vertical import QoSPolicy, qos_for
    eng = cluster_engine()(cfg, params, device=dev, **geometry)
    reqs = requests(cfg, PROMPT_LENS, 32, seed=0)
    for r in reqs:
        r.slo = BATCH if r.rid % 2 == 0 else INTERACTIVE
        eng.submit(r)
    eng.step_many(eng.decode_block)
    eng.step_many(eng.decode_block)
    with resize_probe(dev) as rz:
        evicted = eng.resize(batch_size=geometry["batch_size"] // 2,
                             evict_key=QoSPolicy.evict_key)
        kept = [r.rid for _, r in eng.slot_requests()]
        eng.step_many(eng.decode_block)
        eng.resize(batch_size=geometry["batch_size"])
        eng.resume(evicted)
        drive(eng)
        sync(dev)
    assert sorted(u.snapshot.request.rid for u in evicted) == [0, 2, 4, 6]
    assert sorted(kept) == [1, 3, 5, 7], kept
    assert all(qos_for(u.slo).burst_only for u in evicted)
    assert all(r.done and len(r.out_tokens) == 32 for r in reqs)
    ms = [(x["lanes"], x["pool"], device_ms(x["ev"])) for x in rz]
    log(f"  QoS-keyed shrink at full width: 8 -> 4 lanes evicts the 4 "
        f"BestEffort units (rids 0, 2, 4, 6) and keeps the Guaranteed "
        f"ones; grown back and resumed, all 8 streams run to 32 tokens; "
        + "; ".join(f"{a[0]} -> {a[1]} lanes, pool {b[0]} -> {b[1]} "
                    f"blocks, {t:.3f} ms device" for a, b, t in ms))
    del eng, evicted
    want = lone_engine_streams(cfg, params, dev,
                               requests(cfg, PROMPT_LENS, 32, seed=0),
                               geometry)
    assert {r.rid: list(r.out_tokens) for r in reqs} == want
    log(f"  every stream equals the lone {geometry['batch_size']}-lane "
        f"engine's ({cfg.compute_dtype}); peak memory allocated "
        f"{peak_gib():.2f} GiB")
    release(dev)
    return ms


def vertical_phase(cfg, params, dev, geometry):
    """Phase 19 (b): the vertical A/B.  Returns the paged launches by run
    and the numbers."""
    base, top = VERTICAL_LANES
    log(f"[vertical] {cfg.name} ({cfg.compute_dtype}) paged replicas "
        f"{dict(geometry, batch_size=base)}, {base} -> {top} lanes, "
        f"{VERTICAL_BATCH} batch requests at t=0, {VERTICAL_SURGE} "
        f"interactive at t={VERTICAL_SURGE_T}")
    lone = {}
    for lanes in VERTICAL_LANES:
        lone[lanes] = lone_engine_streams(
            cfg, params, dev, [r for _, r in vertical_requests(cfg)],
            dict(geometry, batch_size=lanes))
    release(dev)
    by_path, numbers, arms = {}, {}, {}
    for tag, vertical in (("horizontal", False), ("vertical", True)):
        cl, reqs, out, wall, probe, launches, resizes = vertical_run(
            cfg, params, dev, vertical, geometry)
        check_served(f"vertical {tag}", reqs, out, probe, launches, None,
                     dev)
        arms[tag] = ({r.rid: list(r.out_tokens) for r in reqs}, out)
        log_cluster_run(f"{tag} arm", cl, out, wall, probe, launches)
        check_evictions(resizes)
        for rz in resizes:
            log(f"    resize {rz['lanes'][0]} -> {rz['lanes'][1]} lanes, "
                f"pool {rz['pool'][0]} -> {rz['pool'][1]} blocks: "
                f"{device_ms(rz['ev']):.3f} ms device, evicted QoS ranks "
                f"{rz['evicted']}, kept {rz['kept']}")
        log(f"    {tag}: interactive attainment "
            f"{out['attainment_interactive']:.3f}, fleet dollars "
            f"{out['fleet_dollar_cost']:.6f}, replicas {len(cl.replicas)}, "
            f"grows {out['vertical_grows']}, shrinks "
            f"{out['vertical_shrinks']}, evictions "
            f"{out['vertical_evictions']}, resumes {out['resumes']}")
        by_path[f"{CLUSTER_ARCH} {tag} ({cfg.compute_dtype})"] = {
            "paged_attention": launches, "ssd_intra_chunk": 0}
        numbers[tag] = {
            "wall_s": wall, "virtual_s": out["virtual_seconds"],
            "attainment_interactive": out["attainment_interactive"],
            "fleet_dollars": out["fleet_dollar_cost"],
            "replicas": len(cl.replicas), "grows": out["vertical_grows"],
            "shrinks": out["vertical_shrinks"],
            "evictions": out["vertical_evictions"],
            "resize_ms": [device_ms(rz["ev"]) for rz in resizes],
            "pools": [rz["pool"] for rz in resizes], "peak_gib": peak_gib()}
        del cl, reqs, probe
        release(dev)
    (h_streams, h), (v_streams, v) = arms["horizontal"], arms["vertical"]
    assert v["vertical_grows"] >= 1 and v["vertical_shrinks"] >= 1, v
    assert h["vertical_grows"] == h["vertical_shrinks"] == 0, h
    assert v["resumes"] >= v["vertical_evictions"], v
    assert v["attainment_interactive"] >= h["attainment_interactive"], (v, h)
    assert v["fleet_dollar_cost"] < h["fleet_dollar_cost"], (v, h)
    log(f"  vertical: attainment {v['attainment_interactive']:.3f} against "
        f"{h['attainment_interactive']:.3f}, fleet dollars "
        f"{v['fleet_dollar_cost']:.6f} against {h['fleet_dollar_cost']:.6f}")
    # the horizontal arm decodes at the lone engine's M throughout and
    # must give its streams; a vertical stream that decoded at 8 lanes
    # ran its GEMMs at another M, which in bf16 may round otherwise: it
    # may leave the 4-lane lone engine's stream, but only at the token
    # where the 8-lane lone engine leaves it (float32: nowhere)
    assert h_streams == lone[base], "the horizontal arm's streams moved"
    left = {}
    for rid, toks in v_streams.items():
        at = first_difference(toks, lone[base][rid])
        if at is not None:
            left[rid] = (at, first_difference(lone[top][rid],
                                              lone[base][rid]))
            log(f"    vertical r{rid} leaves the {base}-lane lone engine's "
                f"stream at token {at}; the {top}-lane lone engine leaves "
                f"it at {left[rid][1]}")
    if cfg.compute_dtype == "float32":
        assert not left, left
    assert all(a == b for a, b in left.values()), left
    log(f"  {cfg.compute_dtype}: the horizontal arm's streams equal the "
        f"{base}-lane lone engine's; {len(left)} vertical streams leave "
        f"them, each where the {top}-lane lone engine does")
    numbers["left_at"] = left
    return by_path, numbers


def first_difference(a, b):
    """The first index where two token lists differ (None if equal)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


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
    t_phase = time.perf_counter()
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
    log("[kernel] paged_attention vs plain at qwen2-moe-a2.7b shapes "
        "(H=KV=16, D=128: a GQA group of 1)")
    paged["at_moe"] = paged_kernel_phase(dev, flush, H=16, KV=16, D=128)
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    paged["empty_launch_ms"] = cuda_ms(lambda: pa_kernel.empty_launch(dev),
                                       50, flush)
    log(f"  empty launch through the same ctypes path: "
        f"{paged['empty_launch_ms']:.4f} ms (L2 flushed)")
    log("[kernel] paged_attention: three calls back to back")
    paged_back_to_back(dev)
    log("[kernel] paged_attention as built: ptxas and SASS")
    paged["sass_hmma"] = paged_build_phase()
    t_phase = lap("phase 3 (paged attention)", t_phase)

    # 4. SSD intra-chunk vs plain, then the kernel as built
    log("[kernel] ssd_intra_chunk vs plain at full prefill-chunk shapes "
        "and zamba2-2.7b's long prefill")
    ssd = ssd_kernel_phase(dev, flush)
    log("[kernel] ssd_intra_chunk as built: ptxas and SASS")
    ssd["sass_hmma"] = ssd_build_phase()
    t_phase = lap("phase 4 (SSD)", t_phase)

    # 13. flash attention vs plain
    log("[kernel] flash_attention vs plain (5 test shapes, then S=16384 "
        "at granite-8b and zamba2-2.7b shapes)")
    flash = flash_kernel_phase(dev, flush)
    log("[kernel] flash_attention as built: ptxas and SASS")
    flash["sass_hgmma"] = flash_build_phase()
    t_phase = lap("phase 13 (flash attention)", t_phase)

    # 8. the tile runtime's first steps and a steady window
    steady_launches = stencil_steady_phase(dev)

    # 9. Jacobi stencil vs plain, then its tile form at full size
    log("[kernel] jacobi vs plain (5 test shapes, 16384^2, 32768^2)")
    jac = jacobi_kernel_phase(dev, flush)
    log("[kernel] jacobi tile form at 16384^2, 4 PEs x odf 4, after LB")
    jac["tile_form"] = tile_form_phase(dev, flush)
    del flush_buf
    torch.cuda.empty_cache()
    t_phase = lap("phases 8-9 (tile runtime, Jacobi)", t_phase)

    # 5-6. the main paths, then kernels vs plain at full width and depth
    by_path = {}
    ssd["launches_by_len"], ssd["per_layer_est_ms"] = {}, {}
    for arch, attn_layers, mamba_layers in PATHS:
        engine, params, launches, steady, by_len = serve_path(
            arch, attn_layers, mamba_layers, dev)
        by_path[arch] = launches
        if mamba_layers:
            ssd["launches_by_len"][arch] = by_len
            ssd["per_layer_est_ms"][arch] = ssd_per_layer_est_ms(
                ssd["at_shapes"], arch, by_len, mamba_layers)
        cfg = engine.cfg
        if cfg.family == "moe":
            moe_ms = moe_block_timing(cfg, params, dev)
            log(f"[moe] numbers {json.dumps(moe_ms)}")
        if cfg.family in ("dense", "moe"):
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
        torch.cuda.reset_peak_memory_stats()
        params32 = zoo.init_serving_params(cfg32, seed=0, device=dev)
        if cfg.family in ("dense", "moe"):
            step_vs_plain(cfg32, params32, shape, pool_blocks, saved,
                          F32_STEP_TOL)
            del saved
        else:
            prefill_step_vs_plain(cfg32, params32, dev, F32_PREFILL_TOL)
        log(f"  float32 check: peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        del params32
        torch.cuda.empty_cache()
        t_phase = lap(f"phases 5-6 ({arch})", t_phase)
    # 14-15. the long-prompt paths (granite-8b, then the hybrid route
    # through zamba2-2.7b's shared attention), then each model's
    # 16384-token prefill, kernel vs plain at full depth
    flash["launches_by_path"] = {}
    for arch, prompts, batch_size, n_long in LONG_PATHS:
        engine, params, long, launches = long_engine_phase(
            arch, prompts, batch_size, dev)
        assert len(long) == n_long, len(long)
        flash["launches_by_path"][f"{arch} long prompts"] = launches
        profiled = long_prefill_profile(engine, params, long[-1])
        if profiled["ssd_launches"]:
            ssd["long_prefill"] = {arch: profiled}
        del engine
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        long_prefill_vs_plain(cfg, params, dev, BF16_LONG_TOL)
        del params
        torch.cuda.empty_cache()
        cfg32 = cfg.with_(compute_dtype="float32")
        params32 = zoo.init_serving_params(cfg32, seed=0, device=dev)
        long_prefill_vs_plain(cfg32, params32, dev, F32_LONG_TOL)
        del params32
        torch.cuda.empty_cache()
    flash["launches"] = sum(flash["launches_by_path"].values())
    t_phase = lap("phases 14-15 (long prompts)", t_phase)

    # 7. small float32 parity on the card: dense vs paged engine
    for arch, _, _ in PATHS:
        small = get_config(arch).reduced().with_(compute_dtype="float32")
        sp = zoo.init_serving_params(small, seed=0, device=dev)
        streams = []
        for mode in ("dense", "paged", "paged"):
            eng = ServingEngine(small, sp, batch_size=3, max_seq=96,
                                prefill_buckets=(16, 64), cache_mode=mode,
                                block_size=8, device=dev)
            rs = requests(small, [5, 20, 70, 90, 12, 40], 6, seed=11)
            for r in rs:
                eng.submit(r)
            eng.run_until_idle()
            assert all(r.done for r in rs)
            streams.append([r.out_tokens for r in rs])
        assert streams[0] == streams[1] == streams[2], streams
        log(f"[small] reduced {arch} f32: dense and paged (kernel) engines "
            f"give identical greedy streams, and a second paged run again")
    t_phase = lap("phase 7 (reduced float32 parity)", t_phase)

    # 17. work-unit migration on the card, full width
    migrated, migration = migration_phase(dev)
    by_path.update(migrated)
    log(f"[migrate] numbers {json.dumps(migration)}")
    t_phase = lap("phase 17 (migration)", t_phase)

    # 18. the serving cluster on the card, full width; 19. market and
    # vertical A/Bs over the same params; then the launcher's three modes
    cfg = get_config(CLUSTER_ARCH)
    params = zoo.init_serving_params(cfg, seed=0, device=dev)
    clustered, cluster = cluster_phase(cfg, params, dev)
    by_path.update(clustered)
    log(f"[cluster] numbers {json.dumps(cluster)}")
    t_phase = lap("phase 18 (cluster)", t_phase)
    marketed, market = market_phase(cfg, params, dev, MARKET_GEOMETRY)
    by_path.update(marketed)
    log(f"[market] numbers {json.dumps(market)}")
    resized, vertical = vertical_phase(cfg, params, dev, CLUSTER_GEOMETRY)
    by_path.update(resized)
    log(f"[vertical] numbers {json.dumps(vertical)}")
    del params
    release(dev)
    # the vertical A/B and the QoS-keyed shrink again in float32, where
    # every stream must equal the lone engine's
    cfg32 = cfg.with_(compute_dtype="float32")
    params32 = zoo.init_serving_params(cfg32, seed=0, device=dev)
    resized, vertical = vertical_phase(cfg32, params32, dev,
                                       CLUSTER_GEOMETRY)
    by_path.update(resized)
    log(f"[vertical] numbers {json.dumps(vertical)}")
    qos_shrink_check(cfg32, params32, dev, CLUSTER_GEOMETRY)
    del params32
    release(dev)
    for what, flags in LAUNCHES:
        launches, out, wall, peak = launcher_run(what, flags, dev)
        by_path[f"{CLUSTER_ARCH} {what}"] = {"paged_attention": launches,
                                             "ssd_intra_chunk": 0}
        log(f"  {what}: wall {wall:.2f} s, peak {peak:.2f} GiB, summary "
            f"{json.dumps(out)}")
    # the moe family through the launcher: one engine, then a cluster
    # with a drained interruption
    by_path[f"{MOE_ARCH} launcher"] = {
        "paged_attention": single_launcher_run(MOE_ARCH, MOE_ATTN_LAYERS,
                                               dev),
        "ssd_intra_chunk": 0}
    launches, out, wall, peak = launcher_run(
        "moe cluster launcher", LAUNCHES[0][1], dev, MOE_ARCH,
        MOE_ATTN_LAYERS)
    by_path[f"{MOE_ARCH} cluster launcher"] = {"paged_attention": launches,
                                               "ssd_intra_chunk": 0}
    log(f"  moe cluster launcher: wall {wall:.2f} s, peak {peak:.2f} GiB, "
        f"summary {json.dumps(out)}")
    t_phase = lap("phase 19 and the launchers", t_phase)
    for record, key in ((paged, "paged_attention"), (ssd, "ssd_intra_chunk")):
        record["launches_by_path"] = {a: c[key] for a, c in by_path.items()
                                      if c[key]}
        record["launches"] = sum(record["launches_by_path"].values())

    # 16. the same at a bucket past 8192
    small_long_parity(dev)
    t_phase = lap("phase 16 (long-bucket parity)", t_phase)

    # 10-12. the stencil app: C1 and C2, correctness, the event driver
    by_run = {"steady window": steady_launches, **stencil_app_phase(dev)}
    stencil_checks_phase(dev)
    by_run["driver"] = stencil_driver_phase(dev)
    jac["launches_by_path"] = by_run
    jac["launches"] = sum(by_run.values())
    lap("phases 10-12 (stencil app)", t_phase)

    log(f"[total] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": [paged, ssd, flash, jac]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
