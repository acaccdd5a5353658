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
   streams, and a second paged run gives them again bit for bit; then
   the float32 recurrent decode state at full width
   (``recurrent_f32_phase``): mamba2-780m at ``F32_CHAIN`` layers and
   zamba2-2.7b at one period, 10 tokens fed one serve step at a time,
   dense and paged, against ``make_prefill`` of each prefix (the SSD
   kernel), each step's logits relative to the largest; mamba2-780m held
   to ``F32_CHAIN_TOL`` (1e-5), zamba2-2.7b printed (its shared
   attention reads the bf16 cache where the prefill reads float32 k and
   v); beside them the same dense chain on a bf16 conv leaf, the state
   before the leaf followed the compute dtype;
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
   zamba2-2.7b's (H=KV=32, D=80), bf16, causal, and at phase 21's two
   (S=8704): the seamless-m4t-medium encoder's (H=KV=16, D=64,
   non-causal) and internvl2-26b's (H=48, KV=8, D=128, causal: a GQA
   group of 6), read through the
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
15. kernel vs plain: one 16384-token ``make_prefill`` of granite-8b and
   of zamba2-2.7b with ``impl="kernel"`` and ``impl="ref"`` from the
   same tokens, last-position logits in bf16 and float32 (granite-8b at
   8 layers, zamba2-2.7b at two periods, 12 layers: ``LONG_PARITY_
   LAYERS``) within a stated tolerance;
16. reduced granite-8b in float32 with a bucket of 8704: the dense engine
   (flash kernel) and the paged engine give the same greedy streams for
   a prompt of 8300 tokens and two short ones;
17. work-unit migration on the card, after phase 7, for granite-8b,
   zamba2-2.7b and qwen2-moe-a2.7b at full width and a third of their
   depth (12, 18 and 8 layers; phase 5's engine and requests):
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
   paged granite-8b replicas at full width and ``CLUSTER_LAYERS`` (4)
   layers (one ``params`` shared, random
   bf16 weights from seed 0, 8 lanes, 1024 positions, blocks of 16) of
   speeds 2.0 (an accelerator host: ``DeviceEndpoint``), 2.0, 0.7 and
   0.7 (``HostEndpoint``) serves 24 requests of 40-700 prompt tokens, 32
   new each, through two spot interruptions (r0, r1) that drain slots
   mid-decode; every stream equals a lone paged engine's of the same
   geometry, the paged launches (zeroed just before, read just after)
   are 4 x the decode steps summed over the replicas, and the run
   repeated gives the same journal digest and summary (the wall-clock
   keys left out).  Wall and virtual times, per-replica tokens and host
   syncs, each drain's stage ms and bytes per unit by endpoint kind, the
   install ms by where the columns lay and peak memory are logged.  One
   unit staged through each endpoint kind installs into a decoding
   engine in a window with no host sync.  Then a seeded chaos soup with
   one hard kill of its own, survived through checkpoints, the failure
   detector and the straggler policy (every stream again the lone
   engine's), and ``repro_torch.launch.serve.main`` in cluster mode at
   full width and 4 layers (16 of 16 served), after phase 19;
19. the market and vertical layers on the same ``params``, each run's
   paged launches zeroed just before it and read just after (4 x the
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
   otherwise at another M); then the A/B again in float32 (the bf16
   weights freed first), where every stream equals the lone
   engine's, and a QoS-keyed shrink of one 8-lane float32 engine from 8
   to 4 lanes evicts its 4 BestEffort units, which resume to the lone
   engine's streams.  Then the launcher (``--layers 4``) in three modes:
   phase 18's drained interruption, ``--market adjusted --fallback
   different_market --scaling cost_aware --slo-mix 0.5 --router
   slo_aware``, and ``--vertical window --qos --slo-mix 0.5`` (16 of 16
   served each, evictions BestEffort first); then qwen2-moe-a2.7b
   through the launcher at full width and 4 layers, one paged engine (8
   of 8 served) and the drained cluster mode (16 of 16), each with paged
   launches = 4 x the decode steps;
20. training, after phase 19 (``training_phase``): (a)
   ``ssd_intra_chunk`` under autograd at mamba2-780m's and zamba2-2.7b's
   training chunks (b = 2, nc = 16, l = 256), through ``SSDIntraChunk``
   (one launch forward, none backward): outputs against the plain
   version, the five input gradients against autograd through it, the
   forward kernel's and the backward's (the plain VJP's) ms; (b)
   ``ElasticTrainer`` on full-width, full-depth mamba2-780m (train_4k's
   4096-token sequences, the global batch cut to 8: 4 micro-batches of
   2; remat full; float32 masters, bf16 compute; the test-scale
   schedule), 4 steps, ``rescale(1)`` through the memory store, 2 more,
   beside a twin of 6 straight steps (rescaled after, through the
   device store): every loss finite, the last 3 below the first 3, the
   two runs' losses equal bit for bit, SSD launches (zeroed just before,
   read just after each run) = 48 x 4 x 2 x 6; s/step, tokens/s, peak
   GiB and the four rescale stages logged; (c) one step's gradient
   through the kernel and through the plain SSD, in bf16 and in float32
   (float32 also with an exact float64 SSD core): loss, grad_norm and
   every gradient leaf under ``TRAIN_ROUTE_TOL``; (d) granite-8b at full
   width cut to 1 layer (4 x 4096 tokens), 2 steps, a rescale, 2 more,
   then ``python -m repro_torch.launch.train --arch granite-8b --reduced
   --steps 4`` as a subprocess;
21. the enc_dec and vlm families, after phase 20 (``frontend_phase``):
   seamless-m4t-medium at full width and 6 + 6 of its 12 + 12 layers
   and internvl2-26b at full width and 6 of its 48 layers (the peak
   while its weights are drawn logged), random
   bf16 weights from seed 0, each launch count set to 0 just before each
   run and read just after.  For each: ``ServingEngine(cache_mode=
   "dense")``, 8 lanes, max_seq 512, serves 8 requests of 40-300 prompt
   tokens, 16 new each (every prompt token a decode step: neither family
   has a bulk prefill, ``chunk_prefills`` 0, no kernel launched), then a
   steady 8-step window with zero host syncs under ``set_sync_debug_mode
   ("error")``, its decode tok/s beside the weight-read bound;
   ``cache_mode="paged"`` raises ``ValueError``; one 8704-position
   ``make_prefill`` (seamless: frames and 8704 tokens, flash launches 12,
   6 encoder layers non-causal and 6 decoder self attentions causal;
   internvl2: 256 patch embeddings and 8448 tokens, flash launches 6)
   with the kernel, again for its warm wall time, and with
   ``impl="ref"``: the last logits in bf16 within ``BF16_LONG_TOL``, and
   in float32 (seamless at 6 + 6 layers; internvl2 at 4 layers, 10.9
   GB) within ``F32_LONG_TOL`` with the same greedy token.
   seamless-m4t-medium also trains 3 steps at 4 + 4 layers (train_4k
   sequences, the global batch cut to 8 in 4 micro-batches of 2; no
   kernel: 4096 < 8192; s/step, tokens/s, peak GiB, finite losses) and
   runs ``python -m
   repro_torch.launch.serve --arch seamless-m4t-medium --no-reduced
   --cache-mode dense`` as a subprocess.
22. data-parallel training over ``torch.distributed`` ranks, after
   phase 21 (``dp_phase``): (a) one NCCL rank (a world of 1, a
   ``file://`` rendezvous) trains phase 20's full-width mamba2-780m
   through ``ElasticTrainer(n_devices=1)``'s data-parallel path with
   ZeRO-1 for 3 steps, its losses equal to phase 20's single-device
   twin's first 3 bit for bit, SSD launches 48 x 4 x 2 x 3 (the counts
   set to 0 just before and read just after), s/step, tokens/s, peak
   GiB, then one 1 -> 1 rescale (device store: the four stage ms, the
   gathered state bit for bit across it); (b) two gloo ranks spawned on
   the one card (NCCL cannot put two ranks on one card) probe the
   collectives the step needs on CUDA tensors, then train granite-8b at
   full width and 1 layer with ZeRO-1 (off, the log naming why, if gloo
   refused one) beside an unrescaled twin of 3 steps: 1 step, rescale
   2 -> 1, 1 step (rank 1 sits out), rescale 1 -> 2, 1 step; losses
   within 5e-4 of the twin's, the state gathered bit for bit across
   each rescale, the stage ms and s/step logged; the spawned group is
   killed, and the phase fails naming itself, past ``DP_SPAWN_LIMIT_S``.
23. the mesh's model axis, after phase 22 (``tp_phase``): two gloo ranks
   spawned on the card, in one spawn: (a) the SPMD Jacobi stencil at
   16384^2 float32 over a (2,) mesh, odf 4, 20 iterations, its grid bit
   for bit the single-grid kernel's x 20, its tile-kernel launches (20 a
   rank, counts set to 0 just before and read just after) added to the
   Jacobi row, ms per iteration and the halo exchange's share; (b)
   granite-8b at full width and 1 layer, tensor parallel on (1, 2), 3
   steps, losses within 8e-3 of phase 22(b)'s unrescaled twin's (the
   same seed, data, hp and model); (c) qwen2-moe-a2.7b at full width and
   1 layer, explicit expert parallelism on (1, 2) (30 experts a rank), 3
   steps, losses within 8e-3 of a one-device run with moe_groups=1 made
   before the spawn; (d) mamba2-780m at full width and 2 layers and (e)
   zamba2-2.7b at full width and one period (6 Mamba2 layers, the
   shared attention and MLP), tensor parallel on (1, 2) (24 of 48 and
   40 of 80 SSM heads a rank, the SSD kernel on them; zamba2's 16 of 32
   attention heads), 3 steps of 4 x 4096 tokens, losses within 8e-3 of
   one-device runs of the same cuts made before the spawn, SSD launches
   a rank = Mamba2 layers x 4 micro-batches x 2 x 3 (added to the SSD
   row), the SSD kernel held against its plain version once at 24 and
   40 heads (b 2, nc 16, l 256); (f) seamless-m4t-medium at full width
   and 1 encoder + 1 decoder layer (8 of 16 heads and KV heads, 2048 of
   4096 ff a rank in the encoder, self and cross attention; the frames
   replicated over the model axis) and (g) internvl2-26b at full width
   and 1 layer (24 of 48 heads, 4 of 8 KV heads, 8192 of 16384 ff a
   rank; the 256 patch positions replicated), tensor parallel on (1, 2),
   3 steps of 4 x 4096 positions (``full_attention``: no kernel), losses
   within 8e-3 of one-device runs of the same cuts made before the
   spawn, each rank under 51% of the parameter bytes; (h) qwen2-moe-a2.7b
   at 1 layer with the grouped dispatch (16 routing groups, 30 experts a
   rank) on (1, 2) against a one-device grouped run; (i) qwen2-moe-a2.7b
   at full width and 1 layer with the one-hot dispatch on a (2, 1) mesh
   (the data axis), 3 steps of 4 x 4096 tokens in 2 micro-batches of 2
   rows, each routed across both ranks (the capacity positions from
   count tables all-gathered over the data ranks: layers x micro-batches
   x 2 all-gathers a step, asserted), losses within 8e-3 of a one-device
   run of the same cut made before the spawn; for (b)-(i) each rank's
   parameter GiB against the whole model's, the model-axis all-reduces
   and routing all-gathers a step, s/step and peak GiB by rank; (j)
   serving over (1, 2): granite-8b at full width and 2 layers in bf16,
   a prefill of 2 lanes x 9216 tokens through ``make_prefill(mesh=)``
   (the flash kernel on each rank's 16 of 32 heads: 2 launches a rank,
   added to the flash row), then 16 ``make_serve_step(mesh=)`` steps
   against an 18432-position cache in the reference's layout (model
   rank 0 holds the prompt's 9216 positions of every KV head, the new
   tokens land on rank 1), fed the tokens of a one-device run of the
   same cut made before the spawn: every step's logits the same on both
   ranks and within 8 bf16 ulps of the largest one-device logit, the
   greedy token equal wherever the top-2 gap allows, the all-reduces and
   all-gathers of the prefill and of each step in closed form (5 and 5),
   each rank's parameter and cache GiB against the whole's; the flash
   kernel held against its plain version at a rank's prefill shape
   before the spawn, its ms beside SDPA's and the bound; (k) the same
   for mamba2-780m and zamba2-2.7b; (l) the pod axis, the same two ranks
   as a (2, 1, 1) ``("pod", "data", "model")`` mesh: (d)'s cut with
   ZeRO-1, each pod rank 2 of the 4 rows (the SSD kernel on them: layers
   x 2 pieces x 2 x 3 launches a rank, asserted), one pod all-reduce of
   each ZeRO-1 block a step, losses within 8e-3 of (d)'s one-device run;
   and (j)'s cell served, each pod rank one lane (the flash kernel on
   all 32 heads: 2 launches a rank), against (j)'s one-device run as (j)
   holds itself, no all-reduce and one all-gather (the logits' rows) a
   prefill and a step, each rank all the parameters and half the cache.
   The spawned group is killed, and the phase fails naming itself, past
   ``TP_SPAWN_LIMIT_S``.
24. the cost analysis against the card, after phase 23
   (``analysis_phase``): (a) one train step of phase 20's dense cell
   (granite-8b at 1 layer, 4 x 4096) and of mamba2-780m at
   ``ANALYSIS_SSM_LAYERS`` (2) layers (8 x 4096, the SSD kernel on its
   path) on the card under ``launch.hlo_analysis.CostCounter``, and the
   same step traced on meta tensors: FLOPs, bytes accessed and kernel
   calls by name equal, the SSD kernel's launches (set to 0 just before,
   read just after; not added to its row) equal its counted calls, the
   trace's peak of live storage within ``ANALYSIS_PEAK_RATIO``
   (0.75-1.33) of the card's peak allocation for the step; the step's
   device ms (CUDA events, a step without the counter) beside the
   trace's t_compute and t_memory at the data sheet's rates, printed,
   not held; (b) meanwhile, in a child process, phase 23's cells (b) and
   (h) traced as rank 0 of a fake (1, 2) process group: the all-reduces
   that ``launch.sharding`` counts equal phase 23's counts a step, and
   the trace's all-reduces over the model group are those plus
   ``DataParallel.norm``'s; and (j)'s, (k)'s and (l)'s prefill and one
   decode step traced on rank 0's blocks: their all-reduces and
   all-gathers equal those the ranks counted on the card; (l)'s train
   step traced on the (2, 1, 1) mesh: its pod all-reduces equal the
   card's, and with the metrics' mean, every all-reduce over 2 ranks.

25. the five examples (``examples/torch_*.py``) in this process on the
   card, each through its ``main`` (``examples_phase``): ``torch_serve``
   (6 requests, 48 tokens), ``torch_serve_cluster`` (nothing dropped
   under any router), ``torch_jacobi_overdecomp`` (its seven lines; its
   Jacobi kernel launches, 4 odf x 12 iterations x 4 PEs, join the
   Jacobi row's ``launches_by_path``), ``torch_quickstart`` (its loss
   bound) and ``torch_train_spot_elastic`` at 4 gloo ranks sharing the
   card, 6 steps, shrink 4 -> 2 and expand 2 -> 4, killed past
   ``EXAMPLE_SPAWN_LIMIT_S``; each example's seconds logged.

Each phase's wall time is logged (``[time]``).  The line before the
last is the ``kernels`` JSON; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import hlo_analysis as H  # noqa: E402

# H100 SXM data sheet: the HBM rate and the dense bf16 tensor peak are the
# cost analysis's own constants
HBM_BYTES_PER_S, BF16_FLOPS = H.HBM_BW, H.PEAK_FLOPS
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
# layers per decode step, Mamba2 layers per chunk prefill), at full width
# and a third of the depth (12, 18 and 8 layers; full depth until PR 35,
# cut for time: the phase holds streams, host syncs and columns, which
# depth does not change).
MIGRATE_PATHS = (("granite-8b", 12, 0), ("zamba2-2.7b", 3, 18),
                 (MOE_ARCH, 8, 0))
MIGRATE_PACK, MIGRATE_PREEMPT = [1, 4, 6], [0, 3]
# The first decode step after an install into another geometry (a dense
# cache, 32-position blocks, 4 lanes after a resize) against the same
# step in the source geometry, on bit-identical caches: the step's own
# arithmetic differs (the dense cache's plain attention against the paged
# kernel, another page walk, cuBLAS at M = 4), and layers of random
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
# Depth is not what these phases hold (the timeline follows the token
# counts only), so their granite-8b keeps its width and is cut to
# CLUSTER_LAYERS layers: paged launches = CLUSTER_LAYERS x decode steps.
CLUSTER_ARCH, CLUSTER_LAYERS = "granite-8b", 4
CLUSTER_ATTN_LAYERS = CLUSTER_LAYERS
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
# qwen2-moe-a2.7b through the launcher, at full width cut like the
# cluster's granite-8b
MOE_LAUNCH_LAYERS = CLUSTER_LAYERS
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
# (model, S, H, KV, D, causal): the 16384-token prefills of phases 14-15,
# then the two shapes of phase 21's 8704-position prefills (the
# seamless-m4t-medium encoder, non-causal; internvl2-26b's decoder, a GQA
# group of 6).
FLASH_FULL = (("granite-8b", 16384, 32, 8, 128, True),
              ("zamba2-2.7b", 16384, 32, 32, 80, True),
              ("seamless-m4t-medium encoder", 8704, 16, 16, 64, False),
              ("internvl2-26b", 8704, 48, 8, 128, True))
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
# One 16384-token prefill of granite-8b or zamba2-2.7b, kernel vs plain
# (``blockwise_attention``'s plain form), last-position logits:
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
# The parity checks' depth: granite-8b's 36 float32 layers are 33 GB to
# draw, and its bf16 plain form took 14.9 s at 36 layers; zamba2-2.7b's
# 54 took 15.1 s in both dtypes.  A few layers hold the same kernel
# against the same plain form (zamba2-2.7b's a whole period each, its
# shared attention twice), and the script keeps within its budget.
LONG_PARITY_LAYERS = {"granite-8b": 8, "zamba2-2.7b": 12}


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
    the kernel's ``cost`` at the lanes' lengths (read here)."""
    from repro_torch.kernels.paged_attention import kernel
    flops, nbytes = kernel.cost(*args, lens=args[4].tolist())
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


def meta(*shape, dtype=None):
    """A meta tensor (shape and dtype, no storage) for a kernel's
    ``cost``."""
    import torch
    return torch.empty(shape, dtype=dtype or torch.float32, device="meta")


def ssd_bound(l, h, p, n, bc=1):
    """(flops, bytes, bound ms, FFMA bound ms) of one intra-chunk call over
    ``bc`` = b * nc chunks, from the kernel's ``cost``.  The bound is the
    kernel's route (3xTF32 on the tensor cores); the FFMA bound stands
    beside it."""
    from repro_torch.kernels.ssd import kernel
    flops, bytes_moved = kernel.cost(
        meta(1, bc, l, h, p), meta(1, bc, l, h), meta(1, bc, l, h),
        meta(1, bc, l, n), meta(1, bc, l, n))
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
        flops, nbytes = kernel.cost(n * n, torch.float32)
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
    from repro_torch.kernels.jacobi import kernel as jacobi_kernel
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
    bound_ms = jacobi_kernel.cost(len(ids) * h * w, torch.float32)[1] \
        / HBM_BYTES_PER_S * 1e3
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


def flash_bound(S, H, KV, D, elem_bytes, peak, causal=True):
    """(flops, bytes, bound ms) of one call at batch 1, from the kernel's
    ``cost``."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    dt = {2: torch.bfloat16, 4: torch.float32}[elem_bytes]
    kv = meta(1, KV, S, D, dtype=dt)
    flops, nbytes = kernel.cost(meta(1, H, S, D, dtype=dt), kv, kv, causal)
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
    for model, S, H, KV, D, causal in FLASH_FULL:
        # the model's (B, S, H, D) tensors, seen heads-major
        q = randn(1, S, H, D).bfloat16().transpose(1, 2)
        k = randn(1, S, KV, D).bfloat16().transpose(1, 2)
        v = randn(1, S, KV, D).bfloat16().transpose(1, 2)
        out = kernel.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, causal=causal)
        assert torch.isfinite(out).all() and out.transpose(1, 2)\
            .is_contiguous()
        e, rel = assert_scaled(out, ref, FLASH_FULL_TOL, FLASH_FULL_REL_L2,
                               f"{model} S={S} causal={causal} bf16 kernel "
                               f"vs plain")
        kr = k.repeat_interleave(H // KV, 1)      # outside the timing
        vr = v.repeat_interleave(H // KV, 1)

        def library():
            return F.scaled_dot_product_attention(q, kr, vr,
                                                  is_causal=causal)
        lib_err = max_err(library(), ref)
        assert lib_err < 3e-2, lib_err
        ms = cuda_ms(lambda: kernel.flash_attention(q, k, v, causal=causal),
                     5, flush)
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v,
                                                       causal=causal),
                           2, flush)
        library_ms = cuda_ms(library, 10, flush)
        flops, nbytes, bound_ms = flash_bound(S, H, KV, D, 2, BF16_FLOPS,
                                              causal)
        row = {"model": model, "S": S, "H": H, "KV": KV, "D": D,
               "causal": causal, "dtype": "bfloat16", "ms": ms,
               "plain_ms": plain_ms,
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
        log(f"  {model} S={S} H={H} KV={KV} D={D} bf16 causal={causal}: "
            f"kernel "
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
        f"{cfg.num_layers} layers, "
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


def migrate_cfg(arch):
    """Phase 17's model: full width, ``MIGRATE_PATHS``' depth."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    attn, mamba = {a: (n, m) for a, n, m in MIGRATE_PATHS}[arch]
    return cfg.with_(num_layers=mamba if cfg.family == "hybrid" else attn)


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
    cfg = migrate_cfg(arch)
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
    cfg = migrate_cfg("granite-8b")
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
                migrate_cfg(arch), params, want, dev)
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
    unless it is None); the paged kernel launched CLUSTER_ATTN_LAYERS x
    the decode steps summed over the replicas."""
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
    log(f"[cluster] {CLUSTER_ARCH} at full width, {cfg.num_layers} layers, "
        f"paged "
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
    """``repro_torch.launch.serve.main`` in cluster mode at full width and
    ``attn_layers`` layers (its own weights, drawn from seed 0), the
    paged launch count set to 0 just before and read just after: every
    request served, the paged kernel launched ``attn_layers`` x the
    decode steps.  Returns (launches, summary, wall s, peak GiB)."""
    from repro_torch.launch import serve
    argv = ["--arch", arch] + CLUSTER_CLI + flags + (
        ["--layers", str(attn_layers)] if dev.type == "cuda"
        else ["--device", "cpu", "--reduced"])
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
    width and ``attn_layers`` layers (8 requests, 32 new tokens each),
    the paged launch count set to 0 just before and read just after: its
    report says every request was served, and the paged kernel ran
    ``attn_layers`` x the decode steps.  Returns the launches."""
    import io
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--no-reduced", "--cache-mode", "paged",
            "--batch-size", "8", "--max-seq", "1024", "--requests", "8",
            "--max-new", "32"] + (
                ["--layers", str(attn_layers)] if dev.type == "cuda"
                else ["--device", "cpu", "--reduced"])
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


# --------------------------------------------------------------- training
# Phase 20: single-device training through the elastic runtime.
# train_4k's 4096-token sequences, its global batch of 256 cut to 8 for
# mamba2-780m (4 micro-batches of 2: one card, one call's time) and to 4
# for granite-8b cut to DENSE_TRAIN_LAYERS layers; the test-scale schedule of
# tests/test_system.py (the default warms up over 100 steps); float32
# masters, bf16 compute, remat full.
TRAIN_HP = dict(lr=1e-3, warmup_steps=2, total_steps=100)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_STEPS = "mamba2-780m", 8, (4, 2)
DENSE_TRAIN_ARCH, DENSE_TRAIN_LAYERS, DENSE_TRAIN_BATCH = "granite-8b", 1, 4
DENSE_TRAIN_STEPS = (2, 2)
# (a) the SSD Function at the models' training chunks, (b, nc, l, h, p, n):
# a micro-batch of 2 sequences of 4096 tokens in chunks of 256
SSD_TRAIN_SHAPES = (("mamba2-780m", (2, 16, 256, 48, 64, 128)),
                    ("zamba2-2.7b", (2, 16, 256, 80, 64, 64)))
# Outputs: the kernel against its plain version, as phase 4 holds it
# (relative L2: ~2e-7 per output).  Input gradients: the Function's
# backward *is* autograd through the plain version, so against a second
# autograd pass through it they must agree to float32 summation order.
SSD_TRAIN_OUT_REL_L2, SSD_TRAIN_GRAD_REL_L2 = 1e-5, 1e-6
# (c) one train step's gradient, the kernel route against the plain one,
# every leaf by relative L2.  float32: phase 6 found kernel and plain
# 1-3e-4 apart at the logits, as far as the plain version is from an
# exact core, so each leaf is held to 1e-3 and, over all leaves, the
# kernel route may be at most 1.5 times as far from a run with an exact
# (float64) SSD core as the plain route is.  bf16: the SSD output is
# rounded to bf16, and a kernel ~2e-7 off flips some roundings, which 48
# layers carry to the logits and back (on an H100 the leaves read
# 1.2e-2 to 1.02e-1 apart; phase 6 holds bf16 logits to 0.1), so each
# leaf is held to 0.25 (a gradient that lost the scan's share would be
# off by its whole size) and, over all leaves, the kernel route may be
# at most 1.5 times as far from the float32 plain route's gradient as
# the bf16 plain route is.
TRAIN_ROUTE_TOL = {
    "float32": dict(loss_rel=1e-5, grad_norm_rel=1e-4, leaf_rel_l2=1e-3,
                    exact_ratio=1.5),
    "bfloat16": dict(loss_rel=1e-3, grad_norm_rel=1e-2, leaf_rel_l2=0.25,
                     exact_ratio=1.5)}


def train_cfg(arch, dev, **kw):
    """The phase's model and shape: full width on the card, reduced on
    the CPU (a rehearsal)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeConfig
    cfg = get_config(arch).with_(**kw)
    train_4k = SHAPES["train_4k"]
    if dev.type != "cuda":
        return cfg.reduced(), train_4k.reduced()
    batch = TRAIN_BATCH if cfg.family == "ssm" else DENSE_TRAIN_BATCH
    return cfg, ShapeConfig(train_4k.name, train_4k.seq_len, batch, "train")


def ssd_train_inputs(dev, shape, seed):
    """SSD inputs as a training step makes them: x, B, C standard normal;
    dt = softplus(normal + dt_bias) with dt_bias drawn as the models draw
    it (dt in [1e-3, 1e-1]); A in [-16, -1] per head, so dA_cs falls
    thousands over a chunk and exp(seg) overflows above the diagonal."""
    import math
    import torch
    b, nc, l, h, p, n = shape
    g = torch.Generator(dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev)

    def uniform(lo, hi, *s):
        return lo + (hi - lo) * torch.rand(s, generator=g, device=dev)
    dt0 = torch.exp(uniform(math.log(1e-3), math.log(1e-1), h))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dtr = torch.nn.functional.softplus(randn(b, nc, l, h) + dt_bias)
    A = -uniform(1.0, 16.0, h)
    dA_cs = torch.cumsum(dtr * A, dim=2)
    return [randn(b, nc, l, h, p), dtr, dA_cs, randn(b, nc, l, n),
            randn(b, nc, l, n)]


def ssd_grad_phase(dev, flush):
    """(a) ``ssd_intra_chunk`` under autograd at the training chunks:
    through ``SSDIntraChunk`` (one launch forward, none backward), its
    outputs against the plain version and the five input gradients
    against autograd through the plain version; the forward kernel's
    and the backward's (the plain VJP's) ms.  Returns the readings."""
    import torch
    from repro_torch.kernels.ssd import kernel, ops, ssd_intra_chunk_ref
    out = {}
    for model, shape in SSD_TRAIN_SHAPES:
        args = [t.requires_grad_() for t in
                ssd_train_inputs(dev, shape, seed=shape[3])]
        g = torch.Generator(dev).manual_seed(1)
        b, nc, l, h, p, n = shape
        cot = (torch.randn((b, nc, l, h, p), generator=g, device=dev),
               torch.randn((b, nc, h, p, n), generator=g, device=dev))
        kernel.launches = 0
        y, st = ops.ssd_intra_chunk(*args)
        assert type(y.grad_fn).__name__.startswith("SSDIntraChunk"), \
            y.grad_fn
        grads = torch.autograd.grad((y, st), args, cot, retain_graph=True)
        sync(dev)
        assert kernel.launches == 1, kernel.launches
        ref_args = [a.detach().clone().requires_grad_() for a in args]
        y_ref, st_ref = ssd_intra_chunk_ref(*ref_args)
        want = torch.autograd.grad((y_ref, st_ref), ref_args, cot)
        row = {"out_rel_l2": max(rel_l2(y.detach(), y_ref.detach()),
                                 rel_l2(st.detach(), st_ref.detach()))}
        assert row["out_rel_l2"] <= SSD_TRAIN_OUT_REL_L2, row
        names = ("xr", "dtr", "dA_cs", "Br", "Cr")
        for name, a, w in zip(names, grads, want):
            assert torch.isfinite(a).all(), name
            row[f"d{name}_rel_l2"] = rel_l2(a, w)
            assert row[f"d{name}_rel_l2"] <= SSD_TRAIN_GRAD_REL_L2, row
        plain = [a.detach() for a in args]
        row["forward_kernel_ms"] = cuda_ms(
            lambda: kernel.ssd_intra_chunk(*plain), 20, flush)
        row["backward_plain_vjp_ms"] = cuda_ms(
            lambda: torch.autograd.grad((y, st), args, cot,
                                        retain_graph=True), 5, flush)
        row["plain_forward_ms"] = cuda_ms(
            lambda: ssd_intra_chunk_ref(*plain), 5, flush)
        row["forward_bound_ms"] = ssd_bound(l, h, p, n, b * nc)[2]
        log(f"  {model} {shape}: outputs rel L2 {row['out_rel_l2']:.2e}, "
            f"input gradients " + ", ".join(
                f"d{k} {row[f'd{k}_rel_l2']:.1e}" for k in names)
            + f" (limits {SSD_TRAIN_OUT_REL_L2}, {SSD_TRAIN_GRAD_REL_L2});"
            f" forward kernel {row['forward_kernel_ms']:.4f} ms (bound "
            f"{row['forward_bound_ms']:.4f}), backward "
            f"(plain VJP, no kernel) {row['backward_plain_vjp_ms']:.3f} ms,"
            f" plain forward {row['plain_forward_ms']:.3f} ms")
        out[model] = row
        del args, y, st, grads, ref_args, y_ref, st_ref, want, plain
        release(dev)
    return out


def zero_launches():
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.ssd import kernel as sk
    fa.launches = pa.launches = sk.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.ssd import kernel as sk
    return {"paged_attention": pa.launches, "ssd_intra_chunk": sk.launches,
            "flash_attention": fa.launches}


def timed_steps(trainer, n, dev) -> list:
    """``n`` steps of ``trainer``, one at a time: wall seconds of each
    (a step ends with its metrics read back, a wait for the card)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        trainer.train(1, log_every=0)
        sync(dev)
        times.append(time.perf_counter() - t0)
    return times


def trainer_run(cfg, shape, dev, store_kind, steps, rescale_after):
    """An ``ElasticTrainer`` (seed 0) for ``sum(steps)`` steps with
    ``rescale(1)`` after ``steps[0]`` (``rescale_after``: also after the
    last), every launch count set to 0 just before the first step and
    read just after the last.  Returns (trainer, launches, step seconds,
    rescale events, peak GiB)."""
    from repro_torch.launch.train import ElasticTrainer
    from repro_torch.optim import adamw
    release(dev)
    tr = ElasticTrainer(cfg, shape, seed=0, store_kind=store_kind,
                        hp=adamw.HParams(**TRAIN_HP), device=dev)
    sync(dev)
    zero_launches()
    times = timed_steps(tr, steps[0], dev)
    events = []
    if len(steps) > 1:
        events.append(tr.rescale(1))
        times += timed_steps(tr, steps[1], dev)
    sync(dev)
    launches = read_launches()
    if rescale_after:
        events.append(tr.rescale(1))
    return tr, launches, times, events, peak_gib()


def log_trainer(what, cfg, shape, tr, launches, times, events, peak):
    tokens = shape.global_batch * shape.seq_len
    steady = sorted(times[1:])[len(times[1:]) // 2] if len(times) > 1 \
        else times[0]
    losses = [m["loss"] for m in tr.metrics_log]
    log(f"  {what}: {len(times)} steps of {shape.global_batch} x "
        f"{shape.seq_len} tokens, losses {[round(x, 6) for x in losses]}")
    log(f"    s/step {spread(times, 1.0)}, median after the first "
        f"{steady:.3f} s = {tokens / steady:.0f} tokens/s; peak "
        f"{peak:.2f} GiB; launches {launches}")
    for ev in events:
        log(f"    rescale {ev.kind} {ev.from_devices}->{ev.to_devices} "
            f"({type(tr.runtime.store).__name__}): " + ", ".join(
                f"{k} {v * 1e3:.2f} ms" for k, v in ev.stages.items()))
    return {"losses": losses, "step_s": times, "median_step_s": steady,
            "tokens_per_s": tokens / steady, "peak_gib": peak,
            "rescales": [{"store": type(tr.runtime.store).__name__,
                          **{k: v * 1e3 for k, v in ev.stages.items()}}
                         for ev in events]}


def train_twin_phase(dev):
    """(b) mamba2-780m at full width and depth: ``ElasticTrainer`` for
    ``TRAIN_STEPS[0]`` steps, ``rescale(1)`` (memory store),
    ``TRAIN_STEPS[1]`` more; a twin trainer of their sum straight (device
    store; rescaled after, for its stage times).
    Every loss finite, the last 3 below the first 3, the two runs' losses
    equal bit for bit (one stream, cuBLAS deterministic there, the
    embedding's backward sort-based, no float atomics on this path), SSD
    launches = layers x micro-batches x 2 x steps.  Returns (launches by
    run, numbers)."""
    import math
    from repro_torch.models import model_zoo as zoo
    cfg, shape = train_cfg(TRAIN_ARCH, dev)
    n = zoo.num_params(cfg)
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n / 1e9:.3f} B params, batch "
        f"{shape.global_batch} x {shape.seq_len} in {cfg.num_microbatches} "
        f"micro-batches, remat {cfg.remat}, {cfg.compute_dtype} compute, "
        f"{cfg.param_dtype} masters")
    want = cfg.num_layers * cfg.num_microbatches * 2 * sum(TRAIN_STEPS)
    runs, numbers, losses = {}, {}, {}
    for what, store, steps, after in (
            ("rescaled", "memory", TRAIN_STEPS, False),
            ("twin", "device", (sum(TRAIN_STEPS),), True)):
        tr, launches, times, events, peak = trainer_run(
            cfg, shape, dev, store, steps, after)
        numbers[what] = log_trainer(f"{what} ({store} store)", cfg, shape,
                                    tr, launches, times, events, peak)
        losses[what] = numbers[what]["losses"]
        runs[f"{cfg.name} training ({what})"] = launches
        if dev.type == "cuda":
            assert launches["ssd_intra_chunk"] == want, (launches, want)
        ls = losses[what]
        assert all(math.isfinite(x) for x in ls), ls
        assert sum(ls[-3:]) < sum(ls[:3]), ls
        del tr
        release(dev)
    a, b = losses["rescaled"], losses["twin"]
    numbers["twin_max_abs_diff"] = max(abs(x - y) for x, y in zip(a, b))
    log(f"  the rescaled run against the twin: max |loss difference| "
        f"{numbers['twin_max_abs_diff']:.3e} (bit for bit: {a == b})")
    assert a == b, (a, b)
    return runs, numbers


def route_grads(cfg, params, batch, impl, core=None):
    """One train step's gradient half (``train_grads``) through ``impl``,
    with an exact SSD core when ``core`` is "f64"."""
    from repro_torch.models import model_zoo as zoo
    with (ssd_core(core) if core else contextlib.nullcontext()):
        grads, loss, _, _ = zoo.train_grads(params, batch, cfg, impl)
    return grads, float(loss)


def route_phase(dev):
    """(c) one train step's gradient of (b)'s model from one state,
    kernel route against plain route, in float32 (also against a run
    with an exact float64 SSD core) and then in bf16 (both also against
    the float32 plain route's gradient): loss, grad_norm and every
    gradient leaf."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import adamw
    out, exact = {}, None
    for dtype in ("float32", "bfloat16"):
        tol = TRAIN_ROUTE_TOL[dtype]
        cfg, shape = train_cfg(TRAIN_ARCH, dev, compute_dtype=dtype)
        release(dev)
        params = zoo.init_state(cfg, 0, dev).params
        batch = to_device(SyntheticLM(cfg, shape).batch_at(0), dev)
        runs = {"kernel": route_grads(cfg, params, batch, "kernel"),
                "plain": route_grads(cfg, params, batch, "ref")}
        if dtype == "float32":
            runs["f64"] = route_grads(cfg, params, batch, "ref", "f64")
        leaves = {k: adamw.flatten(g)[0] for k, (g, _) in runs.items()}
        names = [n for n, _ in _leaf_names(params)]
        per_leaf = {n: rel_l2(a, b) for n, a, b in
                    zip(names, leaves["kernel"], leaves["plain"])}
        gn = {k: float(adamw.global_norm(g)) for k, (g, _) in runs.items()}
        row = {"loss": {k: v for k, (_, v) in runs.items()},
               "grad_norm": gn, "leaf_rel_l2": per_leaf,
               "max_leaf_rel_l2": max(per_leaf.values())}
        loss_rel = abs(runs["kernel"][1] - runs["plain"][1]) / abs(
            runs["plain"][1])
        gn_rel = abs(gn["kernel"] - gn["plain"]) / gn["plain"]
        log(f"  {dtype}: loss kernel {runs['kernel'][1]:.7f} plain "
            f"{runs['plain'][1]:.7f} (rel {loss_rel:.2e}); grad_norm "
            f"{gn['kernel']:.6f} / {gn['plain']:.6f} (rel {gn_rel:.2e}); "
            f"gradient leaves kernel vs plain, rel L2 up to "
            f"{row['max_leaf_rel_l2']:.2e} ({max(per_leaf, key=per_leaf.get)}"
            f"); limits {tol}")
        assert all(torch_finite(g) for g in leaves["kernel"])
        assert loss_rel <= tol["loss_rel"] and gn_rel <= tol["grad_norm_rel"]
        assert row["max_leaf_rel_l2"] <= tol["leaf_rel_l2"], per_leaf
        # over all leaves, the distance from a more exact gradient: an
        # exact SSD core (float32), the float32 plain route (bf16)
        flat = {k: flat_cat(v) for k, v in leaves.items()}
        ref = flat["f64"] if dtype == "float32" else exact
        far_k, far_p = rel_l2(flat["kernel"], ref), rel_l2(flat["plain"], ref)
        row["from_exact"] = {"kernel": far_k, "plain": far_p}
        what = "exact-core" if dtype == "float32" else "float32 plain"
        log(f"    from the {what} run (all leaves): kernel {far_k:.2e}, plain {far_p:.2e} "
            f"(ratio {far_k / far_p:.2f}, limit {tol['exact_ratio']})")
        assert far_k <= tol["exact_ratio"] * far_p, row["from_exact"]
        if dtype == "float32":
            exact = flat["plain"]
        out[dtype] = row
        del params, batch, runs, leaves, flat, ref
        release(dev)
    return out


def _leaf_names(tree, prefix=""):
    """(dotted name, leaf) pairs in ``adamw.flatten`` order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaf_names(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def torch_finite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


def flat_cat(leaves):
    import torch
    return torch.cat([t.float().reshape(-1) for t in leaves])


def dense_train_phase(dev):
    """(d) granite-8b at full width, depth cut to DENSE_TRAIN_LAYERS: 2
    steps, ``rescale(1)``, 2 steps; then the launcher as a
    subprocess."""
    import math
    from repro_torch.models import model_zoo as zoo
    cfg, shape = train_cfg(DENSE_TRAIN_ARCH, dev)
    if dev.type == "cuda":
        cfg = cfg.with_(num_layers=DENSE_TRAIN_LAYERS)
    log(f"[train] {cfg.name} cut to {cfg.num_layers} layers: "
        f"{zoo.num_params(cfg) / 1e9:.3f} B params, batch "
        f"{shape.global_batch} x {shape.seq_len}")
    tr, launches, times, events, peak = trainer_run(
        cfg, shape, dev, "memory", DENSE_TRAIN_STEPS, False)
    numbers = log_trainer(f"granite-8b, {cfg.num_layers} layers (memory "
                          f"store)", cfg, shape, tr, launches, times, events,
                          peak)
    ls = numbers["losses"]
    assert all(math.isfinite(x) for x in ls), ls
    assert not any(launches.values()), launches   # full_attention: no kernel
    del tr
    release(dev)
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            DENSE_TRAIN_ARCH, "--reduced", "--steps", "4"]
    if dev.type != "cuda":
        argv += ["--device", "cpu"]
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(argv, capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    wall = time.perf_counter() - t0
    assert run.returncode == 0, run.stderr[-4000:]
    assert "done:" in run.stdout, run.stdout
    log(f"  {' '.join(argv[1:])}: exit 0 in {wall:.1f} s; "
        f"{run.stdout.strip().splitlines()[-1]}")
    numbers["launcher_s"] = wall
    return numbers


def training_phase(dev, flush):
    """Phase 20: (a) the SSD Function, (b) mamba2-780m trained across a
    rescale beside a twin, (c) kernel against plain route, (d) granite-8b
    at DENSE_TRAIN_LAYERS layers and the launcher.  Returns (launches by
    run, numbers)."""
    numbers = {}
    log(f"[train] phase 20 on {gpu_line() if dev.type == 'cuda' else dev}")
    if dev.type == "cuda":
        log("[train] (a) ssd_intra_chunk through SSDIntraChunk at the "
            "training chunks")
        numbers["ssd_grad"] = ssd_grad_phase(dev, flush)
    log("[train] (b) mamba2-780m across a rescale, and its twin")
    runs, numbers["mamba2"] = train_twin_phase(dev)
    log("[train] (c) one step's gradient, kernel route vs plain route")
    numbers["routes"] = route_phase(dev)
    log(f"[train] (d) granite-8b at {DENSE_TRAIN_LAYERS} layers, then the "
        f"launcher")
    numbers["dense"] = dense_train_phase(dev)
    return runs, numbers


# ------------------------------------------- phase 21: enc_dec and vlm
# Phase 21: seamless-m4t-medium (enc_dec) and internvl2-26b (vlm) at full
# width, random bf16 weights from seed 0.  Neither family has a bulk
# prefill or a paged cache (as in the reference), so the dense engine
# feeds every prompt token through a decode step, text only.  (model,
# layers a stack: None keeps the published depth.)  Cut for the script's
# time (depth is not what the phase holds): seamless-m4t-medium's 12 + 12
# layers to 6 + 6 (PR 35; flash launches of one FRONTEND_S-position
# prefill: 6 encoder layers non-causal, 6 decoder self attentions
# causal), internvl2-26b's 48 layers (39.7 GB) to 6 (12 until PR 35):
# flash launches = its layers.
FRONTEND_PATHS = (("seamless-m4t-medium", 6), ("internvl2-26b", 6))
FRONTEND_LENS, FRONTEND_NEW = [40, 63, 100, 150, 200, 240, 270, 300], 16
FRONTEND_MAX_SEQ = 512
# One long prefill of 8704 positions (17 blocks of 512, past the 8192
# switch): seamless's frames and tokens, internvl2's 256 patch embeddings
# and 8448 tokens.  Cross attention stays full_attention: float32 logits
# of 16 x 8704^2 (4.85 GB a layer), so the length stays far below the
# reference's prefill_32k.
FRONTEND_S = 8704
# internvl2-26b in float32 is 79.5 GB at full depth: 4 layers (10.9 GB)
FRONTEND_F32_LAYERS = 4
# seamless-m4t-medium's train steps: train_4k sequences, the global batch
# cut to 8 (4 micro-batches of 2, the config's own), as phase 20 cuts it,
# and the depth to FRONTEND_TRAIN_LAYERS a stack (cut from 12 for the
# script's time: depth is not what the steps hold)
FRONTEND_TRAIN_BATCH, FRONTEND_TRAIN_STEPS = 8, 3
FRONTEND_TRAIN_LAYERS = 4


def frontend_setup(arch, layers, dev):
    """(cfg, prefill positions): full width on the card, cut to ``layers``
    layers unless None; on the CPU (a rehearsal) the reduced model,
    blockwise attention at blocks of 32 (the flash kernel's plain
    version) and 64 positions."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if dev.type == "cuda":
        if layers is not None:
            cfg = (cfg.with_(enc_layers=layers, dec_layers=layers)
                   if cfg.family == "enc_dec" else
                   cfg.with_(num_layers=layers))
        return cfg, FRONTEND_S
    return cfg.reduced().with_(attn_impl="blockwise", flash_block_q=32,
                               flash_block_kv=32), 64


def frontend_engine(cfg, params, dev):
    """The dense engine, 8 lanes, serves 8 requests of FRONTEND_LENS prompt
    tokens, FRONTEND_NEW new each, every launch count set to 0 just
    before and read just after (none runs: decode attention is
    ``full_attention``); then a steady 8-step window with zero host
    syncs, its decode tok/s beside the bound of reading every weight once
    a step; then ``cache_mode="paged"`` must raise ``ValueError``."""
    import torch
    from repro_torch.core.checkpointing import tree_leaves
    from repro_torch.serving.engine import ServingEngine
    engine = ServingEngine(cfg, params, batch_size=8,
                           max_seq=FRONTEND_MAX_SEQ, cache_mode="dense",
                           device=dev)
    reqs = requests(cfg, FRONTEND_LENS, FRONTEND_NEW, seed=0)
    for r in reqs:
        engine.submit(r)
    sync(dev)
    zero_launches()
    stats = engine.run_until_idle()
    sync(dev)
    launches = read_launches()
    for r in reqs:
        assert r.done and len(r.out_tokens) == FRONTEND_NEW, r.rid
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)
    assert engine.chunk_prefills == 0 and not any(launches.values()), (
        engine.chunk_prefills, launches)
    log(f"  dense engine served {len(reqs)}/{len(reqs)}: {stats['tokens']} "
        f"tokens, {stats['steps']} decode steps (every prompt token one), "
        f"{stats['seconds']:.2f} s, chunk_prefills 0, launches {launches}, "
        f"host_syncs {engine.host_syncs}")
    steady = requests(cfg, [4] * 8, 64, seed=1, start=100)
    for r in steady:
        engine.submit(r)
    engine.step_many(8)                 # admit + the first window
    syncs = engine.host_syncs
    sync(dev)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        window = engine.step_many(8)
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    sync(dev)
    dt = time.perf_counter() - t0
    assert window["steps"] == 8 and engine.host_syncs == syncs, window
    weight_bytes = sum(t.nbytes for t in tree_leaves(params))
    bound = 8 * HBM_BYTES_PER_S / weight_bytes
    tok_s = window["emitted"] / dt
    log(f"  steady window: 8 fused steps x 8 lanes under sync_debug_mode="
        f"error, 0 host syncs, {dt * 1e3 / 8:.2f} ms/step, {tok_s:.1f} "
        f"decode tok/s against {bound:.0f} tok/s (8 lanes over "
        f"{weight_bytes / 1e9:.2f} GB of weights read a step at the HBM "
        f"rate)")
    try:
        ServingEngine(cfg, params, batch_size=8, max_seq=FRONTEND_MAX_SEQ,
                      cache_mode="paged", device=dev)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"{cfg.name}: a paged engine was built")
    log(f"  cache_mode=paged refused: ValueError({refused!r})")
    return {"served": len(reqs), "steps": stats["steps"],
            "serve_s": stats["seconds"], "host_syncs": engine.host_syncs,
            "steady_ms_per_step": dt * 1e3 / 8, "decode_tok_s": tok_s,
            "decode_bound_tok_s": bound, "paged_refused": refused}


def frontend_batch(cfg, S, dev, seed=9):
    """A prefill batch of ``S`` positions: tokens and bf16 ``frames``
    (enc_dec), or bf16 ``patch_embeds`` and S - frontend_seq tokens."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    vlm = cfg.family == "vlm"
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (1, S - cfg.frontend_seq if vlm else S),
        generator=g, device=dev, dtype=torch.int32)}
    key, n = ("patch_embeds", cfg.frontend_seq) if vlm else ("frames", S)
    batch[key] = torch.randn((1, n, cfg.d_model), generator=g,
                             device=dev).bfloat16()
    return batch


def frontend_prefill_vs_plain(cfg, params, S, dev, tol, want):
    """One S-position ``make_prefill`` with the kernel (flash launches set
    to 0 just before and read just after: ``want``), again for its warm
    wall time, and with ``impl="ref"``: the last-position logits, kernel
    against plain, within ``tol``."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model_zoo as zoo
    shape = ShapeConfig("long", S, 1, "prefill")
    batch = frontend_batch(cfg, S, dev)
    outs, secs, launches = {}, {}, {}
    for run in ("kernel", "kernel again", "ref"):
        sync(dev)
        zero_launches()
        t0 = time.perf_counter()
        logits, state = zoo.make_prefill(cfg, shape, impl=run.split()[0])(
            params, batch)
        sync(dev)
        secs[run] = time.perf_counter() - t0
        launches[run] = read_launches()["flash_attention"]
        outs[run] = logits[0, -1, :cfg.vocab_size].float()
        assert state.cache_len.tolist() == [S], state.cache_len
        del logits, state
        release(dev)
    a, b = outs["kernel"], outs["ref"]
    assert torch.isfinite(a).all() and a.shape == b.shape
    if dev.type == "cuda":
        assert launches == {"kernel": want, "kernel again": want, "ref": 0}, \
            launches
    rel = rel_l2(a, b)
    agree = float(a.argmax() == b.argmax())
    log(f"  {S}-position prefill, {cfg.num_layers} layers, "
        f"{cfg.compute_dtype}: kernel vs plain last logits rel_l2={rel:.3e} "
        f"max_abs={max_err(a, b):.3e} argmax agreement {agree:.0f} (tol "
        f"{tol}); flash launches {launches['kernel']}; wall "
        f"{secs['kernel'] * 1e3:.1f} ms cold, "
        f"{secs['kernel again'] * 1e3:.1f} ms warm, plain "
        f"{secs['ref'] * 1e3:.1f} ms")
    assert rel <= tol["rel_l2"] and agree >= tol["argmax_agree"]
    return {"S": S, "layers": cfg.num_layers, "dtype": cfg.compute_dtype,
            "rel_l2": rel, "argmax_agree": agree,
            "launches": launches["kernel"], "wall_ms": secs["kernel again"] * 1e3,
            "cold_ms": secs["kernel"] * 1e3, "plain_ms": secs["ref"] * 1e3}


def frontend_train(cfg, dev):
    """seamless-m4t-medium trained: FRONTEND_TRAIN_STEPS steps of
    ``ElasticTrainer`` on train_4k sequences at a global batch of 8, cut
    to FRONTEND_TRAIN_LAYERS layers a stack on the card (no kernel runs:
    4096 < 8192 positions), every loss finite."""
    import math
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeConfig
    if dev.type == "cuda":
        n = FRONTEND_TRAIN_LAYERS
        cfg = cfg.with_(enc_layers=n, dec_layers=n, num_layers=2 * n)
    train_4k = SHAPES["train_4k"]
    shape = (ShapeConfig(train_4k.name, train_4k.seq_len,
                         FRONTEND_TRAIN_BATCH, "train")
             if dev.type == "cuda" else train_4k.reduced())
    tr, launches, times, events, peak = trainer_run(
        cfg, shape, dev, "memory", (FRONTEND_TRAIN_STEPS,), False)
    numbers = log_trainer(f"{cfg.name} ({cfg.num_microbatches} "
                          f"micro-batches)", cfg, shape, tr, launches,
                          times, events, peak)
    assert all(math.isfinite(x) for x in numbers["losses"])
    assert not any(launches.values()), launches
    del tr
    release(dev)
    return numbers


def frontend_launcher(arch, dev):
    """``python -m repro_torch.launch.serve --arch <arch> --no-reduced
    --cache-mode dense`` as a subprocess: exit 0, every request served."""
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
            "--no-reduced", "--cache-mode", "dense"]
    if dev.type != "cuda":
        argv += ["--device", "cpu", "--reduced"]
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=env)
    wall = time.perf_counter() - t0
    assert run.returncode == 0, run.stderr[-4000:]
    report = run.stdout.strip().splitlines()[-1]
    assert "cache=dense" in report and "served 8/8" in report, run.stdout
    log(f"  {' '.join(argv[1:])}: exit 0 in {wall:.1f} s; {report}")
    return wall


def frontend_phase(dev):
    """Phase 21.  Returns (flash launches by path, numbers)."""
    from repro_torch.core.checkpointing import tree_leaves
    from repro_torch.models import model_zoo as zoo
    launches, numbers = {}, {}
    for arch, layers in FRONTEND_PATHS:
        cfg, S = frontend_setup(arch, layers, dev)
        # a launch a layer: the encoder's and the decoder's self attention
        want = (cfg.enc_layers + cfg.dec_layers if cfg.family == "enc_dec"
                else cfg.num_layers)
        release(dev)
        t0 = time.perf_counter()
        params = zoo.init_serving_params(cfg, seed=0, device=dev)
        sync(dev)
        rec = {"weight_gb": sum(t.nbytes for t in tree_leaves(params)) / 1e9,
               "draw_peak_gib": peak_gib()}
        log(f"[frontend] {arch} ({cfg.family}): {zoo.num_params(cfg)} params "
            f"({rec['weight_gb']:.2f} GB bf16) drawn in "
            f"{time.perf_counter() - t0:.1f} s, peak "
            f"{rec['draw_peak_gib']:.2f} GiB while drawing")
        rec["engine"] = frontend_engine(cfg, params, dev)
        rec["prefill_bf16"] = frontend_prefill_vs_plain(
            cfg, params, S, dev, BF16_LONG_TOL, want)
        launches[f"{arch} prefill"] = rec["prefill_bf16"]["launches"]
        if cfg.family == "enc_dec":
            rec["launcher_s"] = frontend_launcher(arch, dev)
        del params
        release(dev)
        if cfg.family == "enc_dec":
            rec["train"] = frontend_train(cfg, dev)
        cfg32, want32 = cfg.with_(compute_dtype="float32"), want
        if cfg.family == "vlm" and dev.type == "cuda":
            cfg32 = cfg32.with_(num_layers=FRONTEND_F32_LAYERS)
            want32 = FRONTEND_F32_LAYERS
        params32 = zoo.init_serving_params(cfg32, seed=0, device=dev)
        rec["prefill_f32"] = frontend_prefill_vs_plain(
            cfg32, params32, S, dev, F32_LONG_TOL, want32)
        del params32
        release(dev)
        numbers[arch] = rec
    return launches, numbers


# ------------------------------------------- phase 22: data parallel training
# Phase 22: training over torch.distributed ranks.  (a) one NCCL rank (a
# world of 1) trains phase 20's mamba2-780m (full width and depth, the
# global batch cut to TRAIN_BATCH) with ZeRO-1 through the data-parallel
# path, DP_STEPS steps, then one 1 -> 1 rescale; (b) DP_RANKS gloo ranks
# share the card (NCCL cannot put two ranks on one card) and train
# granite-8b cut to DENSE_TRAIN_LAYERS layers, as phase 20's (d) sizes
# it, with ZeRO-1 across a 2 -> 1 -> 2 rescale, beside an unrescaled
# twin.
DP_STEPS, DP_RANKS = 3, 2
# a hung rank fails (b) after this many wall seconds (the group is
# killed); the spawn read 76 s on an H100 (PERF.md)
DP_SPAWN_LIMIT_S = 300
DP_ELASTIC_LOSS = 5e-4      # tests/test_multidevice.py:106
# what a data-parallel step and a rescale call on a gloo group
DP_COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather", "broadcast")


def state_leaves(st):
    from repro_torch.optim import adamw
    return [t for tree in (st.params, st.opt.m, st.opt.v)
            for t in adamw.flatten(tree)[0]] + [st.step]


def state_kept(tr, rank, dev):
    """After a rescale: whether the state, gathered whole over the new
    mesh (its ZeRO-1 blocks; a collective, so every member calls this),
    equals bit for bit the whole state the rescale's checkpoint gathered
    before it (restored from rank 0's store).  With one member the local
    state is whole and nothing is gathered.  ``None`` off rank 0."""
    rt = tr.runtime
    if not rt.member:
        return None
    whole = rt.gathered_state() if rt.layout.size > 1 else rt.state
    if rank != 0:
        return None
    saved = rt.store.restore("elastic", device=dev)
    return bit_equal(state_leaves(saved), state_leaves(whole))


def bit_equal(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def dp_one_rank_phase(dev, twin_losses):
    """(a) a world of one rank (NCCL on the card, gloo on the CPU):
    ``ElasticTrainer(n_devices=1)`` through the data-parallel path with
    ZeRO-1, ``DP_STEPS`` steps, its losses equal to phase 20's twin's
    first ones (the single-device trainer, the same seed) bit for bit,
    SSD launches = layers x micro-batches x 2 x steps; then one 1 -> 1
    rescale (device store) with the gathered state bit-equal across it.
    Returns (launches, numbers)."""
    import tempfile
    import torch
    from repro_torch.launch import dist as launch_dist
    from repro_torch.launch.train import ElasticTrainer
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import adamw
    cfg, shape = train_cfg(TRAIN_ARCH, dev, zero1=True)
    release(dev)
    with tempfile.TemporaryDirectory() as tmp, launch_dist.process_group(
            0, 1, launch_dist.file_rendezvous(tmp), dev) as rank_dev:
        backend = torch.distributed.get_backend()
        tr = ElasticTrainer(cfg, shape, seed=0, store_kind="device",
                            hp=adamw.HParams(**TRAIN_HP), device=rank_dev)
        layout = tr.runtime.layout
        assert isinstance(layout, zoo.DataParallel) and layout.zero1
        sync(dev)
        zero_launches()
        times = timed_steps(tr, DP_STEPS, dev)
        launches = read_launches()
        peak = peak_gib()
        ev = tr.rescale(1)
        same = state_kept(tr, 0, rank_dev)
        numbers = log_trainer(
            f"{cfg.name}, one {backend} rank, ZeRO-1 (device store)", cfg,
            shape, tr, launches, times, [ev], peak)
        del tr
    release(dev)
    losses = numbers["losses"]
    want = cfg.num_layers * cfg.num_microbatches * 2 * DP_STEPS
    log(f"  against phase 20's single-device twin: {losses} vs "
        f"{twin_losses[:DP_STEPS]} (bit for bit: "
        f"{losses == twin_losses[:DP_STEPS]}); state across the rescale "
        f"bit for bit: {same}; SSD launches {launches['ssd_intra_chunk']} "
        f"(want {want} on the card)")
    assert losses == twin_losses[:DP_STEPS], (losses, twin_losses)
    assert same
    if dev.type == "cuda":
        assert launches["ssd_intra_chunk"] == want, (launches, want)
    numbers.update(backend=backend, state_bit_equal=same)
    return launches, numbers


def gloo_probe(dev, world) -> dict:
    """Each collective the step needs, once on a small tensor of ``dev``
    in the current gloo group: "ok" or the error it raised."""
    import torch
    import torch.distributed as dist
    rank = dist.get_rank()
    calls = {
        "all_reduce": lambda t: dist.all_reduce(t),
        "reduce_scatter": lambda t: dist.reduce_scatter(
            torch.empty(2, device=dev), list(t.reshape(world, 2).unbind(0))),
        "all_gather": lambda t: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t),
        "broadcast": lambda t: dist.broadcast(t, 0)}
    out = {}
    for name in DP_COLLECTIVES:
        t = torch.arange(2 * world, dtype=torch.float32, device=dev) + rank
        try:
            calls[name](t)
            sync(dev)
            out[name] = "ok"
        except RuntimeError as e:       # gloo refusing a CUDA tensor
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


def dp_gloo_rank(rank, world, dev, out_path):
    """A rank of (b): probe the collectives; a twin trainer over both
    ranks for 3 steps (then dropped); a trainer of 1 step, ``rescale(1)``
    (rank 1 sits out), 1 step, ``rescale(2)``, 1 step, the state
    bit-equal across each rescale (``state_kept``).  Rank 0 writes the
    readings to ``out_path`` as JSON."""
    import torch
    from repro_torch.launch.train import ElasticTrainer
    from repro_torch.optim import adamw
    probe = gloo_probe(dev, world)
    zero1 = all(v == "ok" for v in probe.values())
    cfg, shape = train_cfg(DENSE_TRAIN_ARCH, dev, zero1=zero1)
    if dev.type == "cuda":
        cfg = cfg.with_(num_layers=DENSE_TRAIN_LAYERS)

    def trainer():
        return ElasticTrainer(cfg, shape, n_devices=world, seed=0,
                              store_kind="device",
                              hp=adamw.HParams(**TRAIN_HP), device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    twin = trainer()
    twin_times = timed_steps(twin, 3, dev)
    twin_losses = [m["loss"] for m in twin.metrics_log]
    del twin
    release(dev)        # the card is shared: hand the twin's memory back
    tr = trainer()
    times, events, same = timed_steps(tr, 1, dev), [], []
    for n in (1, world):
        events.append(tr.rescale(n))
        same.append(state_kept(tr, rank, dev))
        release(dev)    # a rank that left the mesh frees its share
        times += timed_steps(tr, 1, dev)
    if rank == 0:
        out = {"probe": probe, "zero1": zero1, "layers": cfg.num_layers,
               "batch": shape.global_batch, "seq": shape.seq_len,
               "twin_losses": twin_losses, "twin_step_s": twin_times,
               "losses": [m["loss"] for m in tr.metrics_log],
               "step_s": times, "state_bit_equal": same,
               "peak_gib_rank0": peak_gib(),
               "rescales": [{"kind": e.kind, "from": e.from_devices,
                             "to": e.to_devices,
                             **{k: v * 1e3 for k, v in e.stages.items()}}
                            for e in events]}
        Path(out_path).write_text(json.dumps(out))


def dp_gloo_phase(dev):
    """(b) ``DP_RANKS`` gloo ranks spawned on ``dev`` (sharing one card):
    granite-8b at DENSE_TRAIN_LAYERS layers with ZeRO-1 (off if gloo
    refused a collective the step needs: the log names it) across 2 -> 1
    -> 2, the losses
    within ``DP_ELASTIC_LOSS`` of the unrescaled twin's, the state
    bit-equal across each rescale.  Returns the readings."""
    import tempfile
    import torch
    from repro_torch.launch import dist as launch_dist
    release(dev)
    held = (torch.cuda.memory_reserved(dev) / 2**30 if dev.type == "cuda"
            else 0.0)
    log(f"  this process holds {held:.2f} GiB of the card's memory")
    # the ranks share the card: segments that grow in place keep a rank's
    # freed blocks usable by its next, larger requests
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out_path = Path(tmp) / "dp_gloo.json"
            t0 = time.perf_counter()
            launch_dist.spawn(dp_gloo_rank, DP_RANKS, str(out_path),
                              device=dev.type, backend="gloo",
                              timeout=DP_SPAWN_LIMIT_S, what="phase 22(b)")
            wall = time.perf_counter() - t0
            out = json.loads(out_path.read_text())
    finally:
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    out["wall_s"], out["main_process_gib"] = wall, held
    refused = {k: v for k, v in out["probe"].items() if v != "ok"}
    log(f"  gloo on {dev.type} tensors: " + (
        "every collective the step needs accepted" if not refused else
        f"refused {refused}: ZeRO-1 off"))
    log(f"  granite-8b, {out['layers']} layers, batch {out['batch']} x "
        f"{out['seq']}, ZeRO-1 {out['zero1']}, {DP_RANKS} gloo ranks: twin "
        f"losses {out['twin_losses']} (s/step {spread(out['twin_step_s'], 1.0)}"
        f"); rescaled {out['losses']} (s/step {spread(out['step_s'], 1.0)});"
        f" state across each rescale bit for bit: {out['state_bit_equal']};"
        f" rank 0 peak {out['peak_gib_rank0']:.2f} GiB; {wall:.1f} s with "
        f"the spawn")
    for ev in out["rescales"]:
        log(f"    rescale {ev['kind']} {ev['from']}->{ev['to']}: " + ", ".join(
            f"{k} {ev[k]:.2f} ms" for k in ("checkpoint", "restart",
                                            "restore", "loadbalance")))
    diffs = [abs(a - b) for a, b in zip(out["twin_losses"], out["losses"])]
    out["max_loss_diff"] = max(diffs)
    assert len(diffs) == 3 and out["max_loss_diff"] < DP_ELASTIC_LOSS, out
    assert out["state_bit_equal"] == [True, True], out
    assert [e["kind"] for e in out["rescales"]] == ["shrink", "expand"]
    assert all(e["restart"] > 0 for e in out["rescales"])
    return out


def dp_phase(dev, twin_losses):
    """Phase 22.  Returns (SSD launches by run, numbers)."""
    log(f"[dp] phase 22 on {gpu_line() if dev.type == 'cuda' else dev}")
    log(f"[dp] (a) {TRAIN_ARCH} over one rank with ZeRO-1")
    launches, one = dp_one_rank_phase(dev, twin_losses)
    if dev.type == "cuda":
        import torch
        log(f"  after (a): {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
            f"GiB allocated, {torch.cuda.memory_reserved(dev) / 2**30:.2f} "
            f"reserved, {torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} free "
            f"on the card")
    log(f"[dp] (b) {DENSE_TRAIN_ARCH} over {DP_RANKS} gloo ranks on one "
        f"device across a rescale")
    gloo = dp_gloo_phase(dev)
    return ({f"{TRAIN_ARCH} data parallel (1 rank)": launches},
            {"one_rank": one, "gloo": gloo})


# ------------------------------------------- phase 23: the model axis
# Phase 23: the mesh's model axis over TP_RANKS gloo ranks sharing the
# card (NCCL cannot put two ranks on one card), in one spawn: (a) the
# SPMD Jacobi stencil at SPMD_GRID^2 float32 over a (2,) mesh, odf
# SPMD_ODF, SPMD_ITERS iterations, bit for bit the single-grid kernel's;
# (b) granite-8b at full width and DENSE_TRAIN_LAYERS layers, tensor
# parallel on a (1, 2) mesh, TP_STEPS steps; (c) qwen2-moe-a2.7b at full
# width and 1 layer with explicit expert parallelism on (1, 2) (30
# experts a rank), TP_STEPS steps, beside a one-device run with
# moe_groups=1 made here first (the function explicit EP computes on a
# (1, 2) mesh: each rank routes its tokens as one group).
# (d) mamba2-780m at full width and 2 layers, tensor parallel on (1, 2)
# (24 of 48 SSM heads a rank: the SSD kernel on them, forward and remat
# recompute), and (e) zamba2-2.7b at full width and one period (6 Mamba2
# layers, then the shared attention and MLP: 40 of 80 SSM heads, 16 of
# 32 attention heads, 5120 of 10240 ff a rank), TP_STEPS steps each,
# beside one-device runs of the same cut, seed and data made first.
# (f) seamless-m4t-medium at full width and 1 encoder + 1 decoder layer
# (8 of 16 heads and KV heads, 2048 of 4096 ff a rank, in the encoder,
# self and cross attention; the frames replicated over the model axis)
# and (g) internvl2-26b at full width and 1 layer (24 of 48 heads, 4 of
# 8 KV heads, 8192 of 16384 ff a rank; the 256 patch positions
# replicated), TP_STEPS steps each, beside one-device runs likewise.
# (h) (c)'s cut with moe_impl="grouped": the config's 16 routing groups
# a micro-batch, each rank running its 30 experts' slots in every group
# (the single device's function), beside a one-device run of the same
# cut made first.
# (i) qwen2-moe-a2.7b at full width and 1 layer with moe_impl="onehot"
# on a (2, 1) mesh (the data axis): batch 4 x 4096 in 2 micro-batches of
# 2 rows, each routed across both ranks (capacity from its 8192 tokens,
# positions from the count tables all-gathered over the data ranks; a
# rank holds the whole model and the gradient is all-reduced over gloo),
# beside a one-device run of the same cut made first.
# (j) serving over (1, 2): granite-8b's prefill and decode steps at full
# width and 2 layers (the SERVE_* constants below), beside a one-device
# run made first.
# (l) the pod axis: (d)'s and (j)'s cells on a (2, 1, 1) ("pod", "data",
# "model") mesh, in the same spawn and against the same one-device runs
# (POD_TRAIN, below the SERVE_* constants).
TP_RANKS, TP_STEPS = 2, 3
SPMD_GRID, SPMD_ODF, SPMD_ITERS = 16384, 4, 20
TP_BF16_LOSS = 8e-3         # tests/test_multidevice.py:80
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "qwen2-moe-a2.7b", 1
# (key, arch, layers a stack, cell, config overrides): trained on (1, 2)
# against a one-device run of the same cut
ONE_DEVICE_TP = (("ssm", "mamba2-780m", 2, "d", {}),
                 ("hybrid", "zamba2-2.7b", 6, "e", {}),
                 ("enc_dec", "seamless-m4t-medium", 1, "f", {}),
                 ("vlm", "internvl2-26b", 1, "g", {}),
                 ("moe_grouped", MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, "h",
                  {"moe_impl": "grouped"}))
# the same on (2, 1): the data axis
ONE_DEVICE_DATA = (("moe_onehot_data", MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS,
                    "i", {"moe_impl": "onehot", "num_microbatches": 2}),)
# a hung rank fails the phase after this many wall seconds (the group is
# killed); the spawn read 94-139 s on an H100 (PERF.md)
TP_SPAWN_LIMIT_S = 300


def tp_cfg(arch, layers, dev, **kw):
    """Phase 23's model and shape: ``train_cfg``'s full width cut to
    ``layers`` layers (an enc_dec model: ``layers`` in each stack),
    batch DENSE_TRAIN_BATCH of 4096 tokens, on the card (reduced on the
    CPU)."""
    cfg, shape = train_cfg(arch, dev, **kw)
    if dev.type == "cuda":
        cfg = (cfg.with_(enc_layers=layers, dec_layers=layers,
                         num_layers=2 * layers)
               if cfg.family == "enc_dec" else cfg.with_(num_layers=layers))
        shape = dataclasses.replace(shape, global_batch=DENSE_TRAIN_BATCH)
    return cfg, shape


def ssd_tp_heads_check(dev) -> dict:
    """(d) and (e)'s kernel check, before the spawn: the SSD kernel
    against its plain version once at one model rank's heads (half of
    each model's), at the training chunk, held as phase 4 holds it; its
    ms and the plain version's (L2 flushed) beside the bound.  These
    launches are not on a path's count."""
    import torch
    from repro_torch.kernels.ssd import kernel, ssd_intra_chunk_ref
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    out = {}
    for arch, (b, nc, l, h, p, n) in SSD_TRAIN_SHAPES:
        shape = (b, nc, l, h // TP_RANKS, p, n)
        args = ssd_train_inputs(dev, shape, seed=shape[3])
        row = {"shape": shape,
               "max_abs_err": ssd_check(args, f"{arch} at {shape[3]} heads"),
               "ms": cuda_ms(lambda: kernel.ssd_intra_chunk(*args), 20,
                             flush_buf.zero_),
               "plain_ms": cuda_ms(lambda: ssd_intra_chunk_ref(*args), 5,
                                   flush_buf.zero_),
               "bound_ms": ssd_bound(l, shape[3], p, n, b * nc)[2]}
        log(f"  SSD kernel at {arch}'s {shape[3]} heads a rank {shape}: "
            f"max |err| {row['max_abs_err']:.2e} against plain; "
            f"{row['ms']:.4f} ms (plain {row['plain_ms']:.3f}, bound "
            f"{row['bound_ms']:.4f})")
        out[arch] = row
        del args
    del flush_buf
    release(dev)
    return out


# (j): granite-8b at full width and 2 layers in bf16, served over a (1,
# 2) mesh: a prefill of SERVE_LANES lanes x SERVE_PROMPT tokens (the flash
# kernel on each rank's 16 of 32 heads), then SERVE_STEPS decode steps
# against a SERVE_CACHE-position cache whose first SERVE_PROMPT positions
# hold that prefill: model rank 0 holds the prompt, the new tokens land
# on rank 1.  (k) the same for mamba2-780m at 2 layers (24 of 48 SSM
# heads a rank, the SSD kernel on them) and zamba2-2.7b at one period (6
# Mamba2 layers, 40 of 80 SSM heads a rank, then the shared attention on
# 16 of 32 heads, the flash kernel at D = 80 on the prompt).
# SERVE_MODELS: cell -> (arch, layers on the card)
SERVE_MODELS = {"j": ("granite-8b", 2), "k_ssm": ("mamba2-780m", 2),
                "k_hybrid": ("zamba2-2.7b", 6)}
SERVE_K = ("k_ssm", "k_hybrid")
SERVE_LANES = 2
SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS = 9216, 18432, 16
SERVE_BF16_ULPS = 8          # tests/test_torch_engine.py's bf16 rule
# (l): the mesh's axes, and (d)'s cell with ZeRO-1 on it (key, arch,
# layers a stack, cell, config overrides): each pod rank 2 of the 4 rows,
# its blocks of m and v over the data axis (of 1), the gradient summed
# over the pods (one all-reduce of each block a step); (j)'s cell served
# on it, each pod rank one lane (flash on all 32 heads of its prefill)
POD_AXES = ("pod", "data", "model")
POD_TRAIN = ("ssm", "mamba2-780m", 2, "l", {"zero1": True})


def serve_cfg(dev, key="j"):
    """A served cell's model, prefill and decode shapes and steps: full
    width at SERVE_MODELS' layers on the card; reduced on the CPU (a
    hybrid model to one period; 32 and 64 positions, 4 steps)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    arch, layers = SERVE_MODELS[key]
    cfg = get_config(arch)
    if dev.type == "cuda":
        cfg, (p, s, n) = (cfg.with_(num_layers=layers),
                          (SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS))
    else:
        cfg, (p, s, n) = cfg.reduced(), (32, 64, 4)
        if cfg.family == "hybrid":
            cfg = cfg.with_(num_layers=cfg.attn_every)
    return (cfg, ShapeConfig("prefill", p, SERVE_LANES, "prefill"),
            ShapeConfig("decode", s, SERVE_LANES, "decode"), n)


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def serve_decode_state(cfg, dshape, cache, n: int, dev):
    """A whole ``dshape`` decode state whose first ``n`` positions hold a
    prefill's whole ``cache`` (its recurrent leaves as they are),
    ``cache_len`` at ``n``."""
    from repro_torch.models import model_zoo as zoo
    state = zoo.init_decode_state(cfg, dshape, fill_len=n, device=dev)
    for k, v in cache.items():
        (state.cache[k][:, :, :n] if k in ("k", "v") else
         state.cache[k]).copy_(v)
    return state


def serve_one_device(dev, path, key="j") -> dict:
    """A served cell's one-device run, made before the spawn: the
    prefill, then greedy decode steps; the prompt, the tokens fed and
    every step's last logits saved to ``path`` for the ranks (which are
    fed the same tokens); the kernels' launches in the prefill (counts
    set to 0 just before, read just after), seconds, peak GiB."""
    import torch
    from repro_torch.models import model_zoo as zoo
    release(dev)
    cfg, pshape, dshape, steps = serve_cfg(dev, key)
    params = zoo.init_serving_params(cfg, seed=0, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_LANES, pshape.seq_len),
                           generator=torch.Generator().manual_seed(23),
                           dtype=torch.int32)
    prefill = zoo.make_prefill(cfg, pshape)
    sync(dev)
    zero_launches()
    t0 = time.perf_counter()
    logits, pstate = prefill(params, {"tokens": prompt.to(dev)})
    sync(dev)
    prefill_s, launches = time.perf_counter() - t0, read_launches()
    state = serve_decode_state(cfg, dshape, pstate.cache, pshape.seq_len,
                               dev)
    del pstate
    step = zoo.make_serve_step(cfg, dshape)
    out, fed, times = [logits[:, -1].float().cpu()], [], []
    for _ in range(steps):
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        fed.append(tok.cpu())
        t0 = time.perf_counter()
        logits, state = step(params, state, tok)
        sync(dev)
        times.append(time.perf_counter() - t0)
        out.append(logits[:, -1].float().cpu())
    torch.save({"prompt": prompt, "fed": fed, "logits": out}, path)
    row = {"prefill_s": prefill_s, "step_s": times,
           "flash_launches": launches["flash_attention"],
           "ssd_launches": launches["ssd_intra_chunk"],
           "peak_gib": peak_gib()}
    del params, state, logits
    release(dev)
    return row


def serve_rank(dev, ref_path, out_path, key="j", pod=False) -> dict:
    """A served cell on one rank: the rank's blocks of the same
    parameters (``init_serving_params(mesh=...)``), the prefill over the
    (1, 2) mesh (``pod``: (2, 1, 1), (l)) on the global prompt, the
    decode state built from its
    blocks (the prefill's state gathered whole, its k / v into the first
    positions of the longer cache, then this rank's block), and the steps
    fed the one-device run's tokens; every logits saved to ``out_path``.
    Returns seconds (``wall_s``: the whole of it), the prefill's flash
    and SSD launches (counts set to 0 just before, read just after), the
    all-reduces and all-gathers of the prefill and of each step
    (``launch.sharding``'s counts), the rank's parameter and cache GiB
    against the whole's and the cache's layout's, peak GiB."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_zoo as zoo
    t_start = time.perf_counter()
    release(dev)
    cfg, pshape, dshape, _ = serve_cfg(dev, key)
    world = dist.get_world_size()
    mesh = (make_mesh((world, 1, 1), POD_AXES, device=dev) if pod else
            make_mesh((1, world), ("data", "model"), device=dev))
    params = zoo.init_serving_params(cfg, seed=0, device=dev, mesh=mesh)
    ref = torch.load(ref_path)

    def counted(fn, *args):
        sync(dev)
        dist.barrier()
        before = sharding.all_reduces, sharding.all_gathers
        t0 = time.perf_counter()
        out = fn(*args)
        sync(dev)
        return out, (sharding.all_reduces - before[0],
                     sharding.all_gathers - before[1]), \
            time.perf_counter() - t0

    zero_launches()
    (logits, pstate), prefill_colls, prefill_s = counted(
        zoo.make_prefill(cfg, pshape, mesh=mesh), params,
        {"tokens": ref["prompt"].to(dev)})
    launches = read_launches()
    whole = zoo.ServingMesh(cfg, pshape, mesh).gather_state(pstate)
    state = zoo.ServingMesh(cfg, dshape, mesh).place_state(
        serve_decode_state(cfg, dshape, whole.cache, pshape.seq_len, dev))
    del whole, pstate
    step = zoo.make_serve_step(cfg, dshape, mesh=mesh)
    out, colls, times = [logits[:, -1].float().cpu()], [], []
    for tok in ref["fed"]:
        (logits, state), c, s = counted(step, params, state, tok.to(dev))
        out.append(logits[:, -1].float().cpu())
        colls.append(c)
        times.append(s)
    torch.save(out, out_path)
    whole_cache = tree_bytes(zoo.abstract_decode_state(cfg, dshape).cache)
    layout = tree_bytes(zoo.abstract_decode_state(cfg, dshape, mesh).cache)
    row = {"prefill_s": prefill_s, "step_s": times,
           "flash_launches": launches["flash_attention"],
           "ssd_launches": launches["ssd_intra_chunk"],
           "prefill_collectives": prefill_colls,
           "step_collectives": colls,
           "param_gib": tree_bytes(params) / 2**30,
           "whole_param_gib": tree_bytes(zoo.abstract_serving_params(cfg))
           / 2**30,
           "cache_gib": tree_bytes(state.cache) / 2**30,
           "layout_cache_gib": layout / 2**30,
           "whole_cache_gib": whole_cache / 2**30, "peak_gib": peak_gib()}
    del params, state, logits
    release(dev)
    row["wall_s"] = time.perf_counter() - t_start
    return row


def serve_layers(cfg):
    """(attention layers, Mamba2 layers) of a served model: granite-8b's
    layers, mamba2-780m's, zamba2-2.7b's periods (each one shared
    attention and MLP) and Mamba2 layers."""
    if cfg.family == "dense":
        return cfg.num_layers, 0
    if cfg.family == "ssm":
        return 0, cfg.num_layers
    return cfg.num_layers // cfg.attn_every, cfg.num_layers


def serve_collectives(cfg, pod=False) -> dict:
    """A served cell's all-reduces and all-gathers in closed form, a
    prefill's and a step's, on (1, m), m > 1, the KV heads and SSM heads
    split, the cache's positions too, with A attention layers (each with
    its MLP) and M Mamba2 layers: 1 + 2A + 2M all-reduces (the embedding;
    each attention's and MLP's g; each Mamba2 layer's ``ssm_norm``
    squares and ``out_proj``), and a step's A more (each split softmax
    output summed over the ranks); 2A all-gathers (a prefill's k and v to
    the cache's positions; a step's q/k/v, then each rank's largest logit
    and sum) + 1 (the logits' vocab blocks).  ``pod``: on (p, 1, 1),
    p > 1, no all-reduce and one all-gather, the logits' rows over the
    pods."""
    if pod:
        return {"prefill": (0, 1), "step": (0, 1)}
    a, m = serve_layers(cfg)
    return {"prefill": (1 + 2 * a + 2 * m, 2 * a + 1),
            "step": (1 + 3 * a + 2 * m, 2 * a + 1)}


def flash_tp_heads_check(dev, key="j") -> dict:
    """A served cell's flash check, before the spawn: the flash kernel at
    one model rank's prefill shape (SERVE_LANES lanes, SERVE_PROMPT
    tokens, half the heads and KV heads, causal, bf16; granite-8b's D
    128, zamba2-2.7b's 80) against its plain version, held as phase 13
    holds it; its ms, the plain version's and SDPA's (KV repeated outside
    the timing), L2 flushed, beside the bound.  These launches are not on
    a path's count."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_ref,
                                                     kernel)
    cfg, pshape, _, _ = serve_cfg(dev, key)
    B, S = SERVE_LANES, pshape.seq_len
    H, KV, D = cfg.num_heads // TP_RANKS, cfg.num_kv_heads // TP_RANKS, \
        cfg.head_dim
    g = torch.Generator(dev).manual_seed(9)
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=dev).bfloat16()
               .transpose(1, 2) for n in (H, KV, KV))
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    out = kernel.flash_attention(q, k, v, causal=True)
    ref = flash_attention_ref(q, k, v, causal=True)
    e, rel = assert_scaled(out, ref, FLASH_FULL_TOL, FLASH_FULL_REL_L2,
                           f"flash at {cfg.name}'s rank prefill (B {B}, S "
                           f"{S}, H {H}, KV {KV}, D {D}) bf16 kernel vs "
                           f"plain")
    kr, vr = (t.repeat_interleave(H // KV, 1) for t in (k, v))
    flops, nbytes = kernel.cost(q, k, v, True)
    row = {"B": B, "S": S, "H": H, "KV": KV, "D": D, "max_abs_err": e,
           "rel_l2": rel,
           "ms": cuda_ms(lambda: kernel.flash_attention(q, k, v,
                                                        causal=True),
                         5, flush_buf.zero_),
           "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v,
                                                           causal=True),
                               2, flush_buf.zero_),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               q, kr, vr, is_causal=True), 10, flush_buf.zero_),
           "bound_ms": max(flops / BF16_FLOPS,
                           nbytes / HBM_BYTES_PER_S) * 1e3}
    log(f"  flash at {cfg.name}'s rank prefill (H {H}, KV {KV}, D {D}): "
        f"{row['ms']:.4f} ms (plain {row['plain_ms']:.2f}, SDPA "
        f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f})")
    del q, k, v, out, ref, kr, vr, flush_buf
    release(dev)
    return row


def ssd_serve_heads_check(dev) -> dict:
    """(k)'s SSD check, before the spawn: the kernel against its plain
    version at one model rank's heads of the serving prefill (SERVE_LANES
    x SERVE_PROMPT tokens in chunks of 256: b * nc = 72, l = 256; 24 of
    mamba2-780m's heads, 40 of zamba2-2.7b's), held as phase 4 holds it;
    its ms and the plain version's (L2 flushed) beside the bound.  These
    launches are not on a path's count."""
    import torch
    from repro_torch.kernels.ssd import kernel, ssd_intra_chunk_ref
    from repro_torch.configs import get_config
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    out = {}
    for key in SERVE_K:
        cfg = get_config(SERVE_MODELS[key][0])
        l = cfg.ssm_chunk
        bc = SERVE_LANES * SERVE_PROMPT // l
        h, p, n = cfg.ssm_heads // TP_RANKS, cfg.ssm_head_dim, cfg.ssm_state
        args = ssd_phase_inputs(dev, bc, l, h, p, n, seed=h)
        what = f"{cfg.name} serving prefill at {h} heads a rank"
        row = {"bc": bc, "l": l, "h": h, "p": p, "n": n,
               "max_abs_err": ssd_check(args, what),
               "ms": cuda_ms(lambda: kernel.ssd_intra_chunk(*args), 20,
                             flush_buf.zero_),
               "plain_ms": cuda_ms(lambda: ssd_intra_chunk_ref(*args), 5,
                                   flush_buf.zero_),
               "bound_ms": ssd_bound(l, h, p, n, bc)[2]}
        log(f"  SSD kernel at {what} (b*nc {bc}, l {l}, p {p}, n {n}): "
            f"max |err| {row['max_abs_err']:.2e} against plain; "
            f"{row['ms']:.4f} ms (plain {row['plain_ms']:.3f}, bound "
            f"{row['bound_ms']:.4f})")
        out[cfg.name] = row
        del args
    del flush_buf
    release(dev)
    return out


def spmd_stencil_rank(dev) -> dict:
    """(a) on one rank: the SPMD step over the (world,) mesh, its tile
    kernel launches (counts set to 0 just before and read just after
    ``step(grid)``), the global grid bit for bit against the
    single-grid kernel x SPMD_ITERS on rank 0, then ms per iteration of
    ``step.local`` and of its exchange and sweep halves, each window
    started on both ranks together (a barrier)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.spmd_stencil import make_jacobi_spmd_step
    from repro_torch.kernels.jacobi import jacobi
    from repro_torch.kernels.jacobi import kernel as jk
    from repro_torch.launch.mesh import make_mesh
    world, rank = dist.get_world_size(), dist.get_rank()
    n = SPMD_GRID if dev.type == "cuda" else 64
    mesh = make_mesh((world,), ("data",), device=dev)
    step = make_jacobi_spmd_step(mesh, odf=SPMD_ODF, n_iters=SPMD_ITERS)
    grid = torch.randn((n, n), generator=torch.Generator(dev).manual_seed(0),
                       device=dev)
    b = n // world
    block = grid[rank * b:(rank + 1) * b].clone()
    sync(dev)
    jk.launches = 0
    out = step(grid)
    sync(dev)
    launches = jk.launches
    same = None
    if rank == 0:
        want = grid
        for _ in range(SPMD_ITERS):
            want = jacobi(want)
        same = bool(torch.equal(out, want))
        del want
    del grid, out
    release(dev)
    buf, spare = step.buffers(block)
    ids, nbr = step.tables(dev)

    def timed(fn):
        """Seconds of ``fn`` on this rank, the ranks started together."""
        sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        sync(dev)
        return time.perf_counter() - t0

    def sweeps():
        nonlocal buf, spare
        for _ in range(SPMD_ITERS):
            buf, spare = step.sweep(buf, spare, ids, nbr), buf
    total = timed(lambda: step.local(block))
    exchange = timed(lambda: [step.exchange(buf)
                              for _ in range(SPMD_ITERS)])
    sweep = timed(sweeps)
    return {"grid": n, "launches": launches, "bit_equal": same,
            "ms_per_iter": total / SPMD_ITERS * 1e3,
            "exchange_ms_per_iter": exchange / SPMD_ITERS * 1e3,
            "sweep_ms_per_iter": sweep / SPMD_ITERS * 1e3}


def tp_train_rank(cfg, shape, dev, world, model_par=None) -> dict:
    """(b)-(i) on one rank: ``ElasticTrainer`` over a (world /
    model_par, model_par) mesh (``model_par`` None: (1, world)),
    TP_STEPS steps: losses, s/step, the model-axis all-reduces and the
    routing all-gathers a step, this rank's parameter GiB against the
    whole model's, and its peak GiB."""
    import torch
    from repro_torch.launch import sharding
    from repro_torch.launch.train import ElasticTrainer
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import adamw
    release(dev)
    tr = ElasticTrainer(cfg, shape, n_devices=world,
                        model_par=world if model_par is None else model_par,
                        seed=0, store_kind="device",
                        hp=adamw.HParams(**TRAIN_HP), device=dev)
    local = sum(t.numel() * t.element_size()
                for t in adamw.flatten(tr.state.params)[0])
    before, gathers = sharding.all_reduces, sharding.all_gathers
    sync(dev)
    zero_launches()
    times = timed_steps(tr, TP_STEPS, dev)
    out = {"losses": [m["loss"] for m in tr.metrics_log], "step_s": times,
           "launches": read_launches(),
           "all_reduces_per_step": (sharding.all_reduces - before)
           / TP_STEPS,
           "all_gathers_per_step": (sharding.all_gathers - gathers)
           / TP_STEPS, "param_gib": local / 2**30,
           "whole_param_gib": zoo.num_params(cfg) * 4 / 2**30,
           "peak_gib": peak_gib()}
    del tr
    release(dev)
    return out


def pod_train_rank(cfg, shape, dev, world) -> dict:
    """(l)'s training on one rank: ``make_train_step`` over a (world, 1,
    1) ``POD_AXES`` mesh from ``DataParallel.place``'s state, fed the
    batches ``ElasticTrainer`` feeds (seed 0, as (d)'s one-device run),
    TP_STEPS steps: losses, s/step, the pod all-reduces a step
    (``launch.sharding``'s count: one for each ZeRO-1 block), the
    leaves, the kernels' launches (counts set to 0 just before the first
    step, read just after the last), this rank's parameter GiB against
    the whole model's, its m and v GiB, and its peak GiB."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import adamw
    release(dev)
    mesh = make_mesh((world, 1, 1), POD_AXES, device=dev)
    dp = zoo.DataParallel(cfg, mesh)
    state = dp.place(zoo.init_state(cfg, 0, device=dev))
    step = zoo.make_train_step(cfg, adamw.HParams(**TRAIN_HP), mesh=mesh)
    data = SyntheticLM(cfg, shape, seed=0)
    pieces = len(dp.micro_blocks(data.batch_at(0))[0])
    sync(dev)
    zero_launches()
    before = sharding.all_reduces
    losses, times = [], []
    for i in range(TP_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, to_device(data.batch_at(i), dev))
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    out = {"losses": losses, "step_s": times, "launches": read_launches(),
           "pod_all_reduces_per_step": (sharding.all_reduces - before)
           / TP_STEPS,
           "leaves": len(adamw.flatten(state.params)[0]),
           "pieces": pieces, "param_gib": tree_bytes(state.params) / 2**30,
           "whole_param_gib": zoo.num_params(cfg) * 4 / 2**30,
           "moments_gib": (tree_bytes(state.opt.m)
                           + tree_bytes(state.opt.v)) / 2**30,
           "peak_gib": peak_gib()}
    del state, step
    release(dev)
    return out


def tp_rank(rank, world, dev, zero1, out_path):
    """A rank of phase 23: (a)-(l) in turn; every rank's readings
    gathered to rank 0, which writes them to ``out_path`` as JSON ((j)'s,
    (k)'s and (l)'s logits beside it)."""
    import torch.distributed as dist
    out = {"stencil": spmd_stencil_rank(dev)}
    cfg, shape = tp_cfg(DENSE_TRAIN_ARCH, DENSE_TRAIN_LAYERS, dev,
                        zero1=zero1)
    out["dense"] = tp_train_rank(cfg, shape, dev, world)
    cfg, shape = tp_cfg(MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, dev)
    out["moe"] = tp_train_rank(cfg, shape, dev, world)
    for key, arch, layers, _, kw in ONE_DEVICE_TP:
        cfg, shape = tp_cfg(arch, layers, dev, **kw)
        out[key] = tp_train_rank(cfg, shape, dev, world)
    for key, arch, layers, _, kw in ONE_DEVICE_DATA:
        cfg, shape = tp_cfg(arch, layers, dev, **kw)
        out[key] = tp_train_rank(cfg, shape, dev, world, model_par=1)
    tmp = Path(out_path).parent
    out["serve"] = serve_rank(dev, tmp / "serve_ref.pt",
                              tmp / f"serve-{rank}.pt")
    t0 = time.perf_counter()
    out["serve_k"] = {key: serve_rank(dev, tmp / f"serve_ref_{key}.pt",
                                      tmp / f"serve_{key}-{rank}.pt", key)
                      for key in SERVE_K}
    out["serve_k_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    key, arch, layers, _, kw = POD_TRAIN
    cfg, shape = tp_cfg(arch, layers, dev, **kw)
    out["pod_train"] = pod_train_rank(cfg, shape, dev, world)
    out["pod_serve"] = serve_rank(dev, tmp / "serve_ref.pt",
                                  tmp / f"serve_l-{rank}.pt", pod=True)
    out["pod_s"] = time.perf_counter() - t0
    every = [None] * world
    dist.all_gather_object(every, out)
    if rank == 0:
        Path(out_path).write_text(json.dumps(every))


def tp_phase(dev, zero1, twin_losses):
    """Phase 23.  ``zero1``: phase 22's (b) setting, so that (b)'s losses
    meet its unrescaled twin's (``twin_losses``: the same seed, data, hp
    and model, data parallel over 2 ranks) within TP_BF16_LOSS.  Returns
    (the stencil's tile-kernel launches, summed over the ranks, and the
    phase's numbers)."""
    import tempfile
    from repro_torch.launch import dist as launch_dist
    log(f"[tp] phase 23 on {gpu_line() if dev.type == 'cuda' else dev}")
    cfg, shape = tp_cfg(MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, dev)
    log(f"[tp] (c)'s one-device run first: {cfg.name}, {cfg.num_layers} "
        f"layers, moe_groups=1, {TP_STEPS} steps")
    one = trainer_run(cfg.with_(moe_groups=1), shape, dev, "memory",
                      (TP_STEPS,), False)
    one_losses = [m["loss"] for m in one[0].metrics_log]
    one_times, one_peak = one[2], one[4]
    del one
    release(dev)
    log(f"  losses {one_losses}, s/step {spread(one_times, 1.0)}, peak "
        f"{one_peak:.2f} GiB")
    ones = {}
    for key, arch, layers, cell, kw in ONE_DEVICE_TP + ONE_DEVICE_DATA:
        cfg, shape = tp_cfg(arch, layers, dev, **kw)
        log(f"[tp] ({cell})'s one-device run "
            f"first: {cfg.name}, {cfg.num_layers} layers, moe_impl "
            f"{cfg.moe_impl!r}, batch {shape.global_batch} x "
            f"{shape.seq_len}, {TP_STEPS} steps")
        tr, launches, times, _, peak = trainer_run(cfg, shape, dev, "memory",
                                                   (TP_STEPS,), False)
        ones[key] = {"losses": [m["loss"] for m in tr.metrics_log],
                     "step_s": times, "peak_gib": peak,
                     "launches": launches["ssd_intra_chunk"]}
        del tr
        release(dev)
        log(f"  losses {ones[key]['losses']}, s/step {spread(times, 1.0)}, "
            f"peak {peak:.2f} GiB, SSD launches {ones[key]['launches']}")
    ssd_heads = ssd_tp_heads_check(dev) if dev.type == "cuda" else {}
    t_flash = time.perf_counter()
    flash_heads = flash_tp_heads_check(dev) if dev.type == "cuda" else {}
    t_flash = time.perf_counter() - t_flash
    t_checks_k = time.perf_counter()
    k_checks = ({"ssd": ssd_serve_heads_check(dev),
                 "flash": flash_tp_heads_check(dev, "k_hybrid")}
                if dev.type == "cuda" else {})
    t_checks_k = time.perf_counter() - t_checks_k
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out_path = Path(tmp) / "tp.json"
            cfg, pshape, dshape, steps = serve_cfg(dev)
            log(f"[tp] (j)'s one-device run first: {cfg.name}, "
                f"{cfg.num_layers} layers, {cfg.compute_dtype}, prefill "
                f"{SERVE_LANES} x {pshape.seq_len}, {steps} steps against "
                f"{dshape.seq_len} positions")
            t_one = time.perf_counter()
            serve_one = serve_one_device(dev, Path(tmp) / "serve_ref.pt")
            t_one = time.perf_counter() - t_one
            log(f"  prefill {serve_one['prefill_s']:.3f} s (flash launches "
                f"{serve_one['flash_launches']}), s/step "
                f"{spread(serve_one['step_s'], 1.0)}, peak "
                f"{serve_one['peak_gib']:.2f} GiB")
            t_one_k = time.perf_counter()
            one_k = {}
            for key in SERVE_K:
                kcfg, kp, kd, ksteps = serve_cfg(dev, key)
                log(f"[tp] (k)'s one-device run first: {kcfg.name}, "
                    f"{kcfg.num_layers} layers, {kcfg.compute_dtype}, "
                    f"prefill {SERVE_LANES} x {kp.seq_len}, {ksteps} steps "
                    f"against {kd.seq_len} positions")
                one_k[key] = serve_one_device(
                    dev, Path(tmp) / f"serve_ref_{key}.pt", key)
                log(f"  prefill {one_k[key]['prefill_s']:.3f} s (SSD "
                    f"launches {one_k[key]['ssd_launches']}, flash "
                    f"{one_k[key]['flash_launches']}), s/step "
                    f"{spread(one_k[key]['step_s'], 1.0)}, peak "
                    f"{one_k[key]['peak_gib']:.2f} GiB")
            t_one_k = time.perf_counter() - t_one_k
            t0 = time.perf_counter()
            launch_dist.spawn(tp_rank, TP_RANKS, zero1, str(out_path),
                              device=dev.type, backend="gloo",
                              timeout=TP_SPAWN_LIMIT_S, what="phase 23")
            wall = time.perf_counter() - t0
            ranks = json.loads(out_path.read_text())
            serve = serve_check(cfg, torch_load(Path(tmp) / "serve_ref.pt"),
                                [torch_load(Path(tmp) / f"serve-{r}.pt")
                                 for r in range(TP_RANKS)],
                                [r["serve"] for r in ranks], dev, "(j)")
            serve_k = {key: serve_check(
                serve_cfg(dev, key)[0],
                torch_load(Path(tmp) / f"serve_ref_{key}.pt"),
                [torch_load(Path(tmp) / f"serve_{key}-{r}.pt")
                 for r in range(TP_RANKS)],
                [r["serve_k"][key] for r in ranks], dev, "(k)")
                for key in SERVE_K}
            serve_l = serve_check(cfg, torch_load(Path(tmp) / "serve_ref.pt"),
                                  [torch_load(Path(tmp) / f"serve_l-{r}.pt")
                                   for r in range(TP_RANKS)],
                                  [r["pod_serve"] for r in ranks], dev,
                                  "(l)", pod=True)
    finally:
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    st = [r["stencil"] for r in ranks]
    launches = sum(s["launches"] for s in st)
    log(f"  (a) SPMD Jacobi {st[0]['grid']}^2 float32, {TP_RANKS} gloo "
        f"ranks x odf {SPMD_ODF}, {SPMD_ITERS} iterations: bit for bit the "
        f"single-grid kernel's: {st[0]['bit_equal']}; tile launches by rank "
        f"{[s['launches'] for s in st]}; ms/iteration by rank "
        + ", ".join(f"{s['ms_per_iter']:.3f} (exchange "
                    f"{s['exchange_ms_per_iter']:.3f}, sweep "
                    f"{s['sweep_ms_per_iter']:.3f}: exchange share "
                    f"{s['exchange_ms_per_iter'] / (s['exchange_ms_per_iter'] + s['sweep_ms_per_iter']):.1%})"
                    for s in st))
    assert st[0]["bit_equal"] is True, st
    want_launches = SPMD_ITERS if dev.type == "cuda" else 0
    assert all(s["launches"] == want_launches for s in st), st
    numbers = {"stencil": st, "wall_s": wall, "one_device_moe": {
        "losses": one_losses, "step_s": one_times, "peak_gib": one_peak},
        "one_device": ones, "ssd_at_rank_heads": ssd_heads,
        "flash_at_rank_heads": flash_heads,
        "serve": dict(serve, one_device=serve_one),
        "serve_k": {key: dict(serve_k[key], one_device=one_k[key])
                    for key in SERVE_K}, "serve_k_checks": k_checks,
        "pod": {"serve": dict(serve_l, one_device=serve_one)}}
    ssd_launches = {}
    for key, what, want in (
            ("dense", f"(b) {DENSE_TRAIN_ARCH} tensor parallel", twin_losses),
            ("moe", f"(c) {MOE_TRAIN_ARCH} expert parallel", one_losses),
            *((k, f"({c}) {a} " + ("grouped, the experts split" if kw
                                   else "tensor parallel"),
               ones[k]["losses"]) for k, a, _, c, kw in ONE_DEVICE_TP),
            *((k, f"({c}) {a} one-hot over the data ranks",
               ones[k]["losses"]) for k, a, _, c, _ in ONE_DEVICE_DATA)):
        rs = [r[key] for r in ranks]
        data = key in {k for k, *_ in ONE_DEVICE_DATA}
        mesh = f"({TP_RANKS}, 1)" if data else f"(1, {TP_RANKS})"
        if key in ("ssm", "hybrid"):
            arch, layers = {k: (a, n) for k, a, n, _, _ in
                            ONE_DEVICE_TP}[key]
            cfg = tp_cfg(arch, layers, dev)[0]
            got = [r["launches"]["ssd_intra_chunk"] for r in rs]
            want_ssd = cfg.num_layers * cfg.num_microbatches * 2 * TP_STEPS
            log(f"  {what}: SSD launches by rank {got} (want "
                f"{cfg.num_layers} x {cfg.num_microbatches} x 2 x {TP_STEPS} "
                f"= {want_ssd} on the card; the one-device run "
                f"{ones[key]['launches']})")
            if dev.type == "cuda":
                assert got == [want_ssd] * TP_RANKS, (key, got, want_ssd)
                assert ones[key]["launches"] == want_ssd, ones[key]
            ssd_launches[f"{arch} tensor parallel ({TP_RANKS} gloo "
                         f"ranks)"] = sum(got)
        log(f"  {what} on {mesh}: losses {rs[0]['losses']} "
            f"against {[round(x, 6) for x in want]}; s/step "
            f"{spread(rs[0]['step_s'], 1.0)}; "
            + ("router-statistics" if data else "model-axis")
            + f" all-reduces a step "
            f"{rs[0]['all_reduces_per_step']:.0f}; routing all-gathers a "
            f"step {rs[0]['all_gathers_per_step']:.0f}; parameters "
            + ", ".join(f"{r['param_gib']:.2f}" for r in rs)
            + f" GiB by rank of {rs[0]['whole_param_gib']:.2f}; peak "
            + ", ".join(f"{r['peak_gib']:.2f}" for r in rs) + " GiB by rank")
        diffs = [abs(a - b) for a, b in zip(rs[0]["losses"], want)]
        assert len(diffs) == TP_STEPS and max(diffs) < TP_BF16_LOSS, \
            (key, rs[0]["losses"], want)
        assert all(r["losses"] == rs[0]["losses"] for r in rs), rs
        if data:
            # a micro-batch routed across both ranks: one all-gather of
            # the count tables a moe layer a micro-batch, forward and
            # remat's recompute; each rank holds the whole model
            arch, layers, kw = {k: (a, n, w) for k, a, n, _, w in
                                ONE_DEVICE_DATA}[key]
            cfg = tp_cfg(arch, layers, dev, **kw)[0]
            want_gathers = cfg.num_layers * cfg.num_microbatches * (
                2 if cfg.remat == "full" else 1)
            assert all(r["all_gathers_per_step"] == want_gathers
                       for r in rs), (key, want_gathers, rs)
            numbers[key] = {"ranks": rs, "max_loss_diff": max(diffs)}
            continue
        assert all(r["param_gib"] < r["whole_param_gib"] for r in rs), rs
        if key in ("enc_dec", "vlm"):   # only the norms are replicated
            assert all(r["param_gib"] < 0.51 * r["whole_param_gib"]
                       for r in rs), rs
        numbers[key] = {"ranks": rs, "max_loss_diff": max(diffs)}
    numbers["pod"]["train"] = pod_train_check(ranks, ones, dev,
                                              ssd_launches)
    log(f"  {wall:.1f} s with the spawn")
    serve_s = max(r["serve"]["wall_s"] for r in ranks)
    numbers["serve"]["wall_s"] = {"one_device": t_one, "flash_check": t_flash,
                                  "ranks": serve_s}
    log(f"[time] phase 23 (j): {t_one + t_flash + serve_s:.1f} s (the "
        f"one-device run {t_one:.1f}, the flash check {t_flash:.1f}, the "
        f"ranks' serve {serve_s:.1f} of the spawn's {wall:.1f})")
    serve_k_s = max(r["serve_k_s"] for r in ranks)
    numbers["serve_k_wall_s"] = {"one_device": t_one_k,
                                 "kernel_checks": t_checks_k,
                                 "ranks": serve_k_s}
    log(f"[time] phase 23 (k): {t_one_k + t_checks_k + serve_k_s:.1f} s "
        f"(the one-device runs {t_one_k:.1f}, the SSD and flash checks "
        f"{t_checks_k:.1f}, the ranks' serve {serve_k_s:.1f} of the "
        f"spawn's {wall:.1f})")
    pod_s = max(r["pod_s"] for r in ranks)
    numbers["pod"]["wall_s"] = pod_s
    log(f"[time] phase 23 (l): {pod_s:.1f} s (the ranks' training and "
        f"serve over ({TP_RANKS}, 1, 1), of the spawn's {wall:.1f}; the "
        f"one-device runs are (d)'s and (j)'s)")
    return launches, ssd_launches, numbers


def pod_train_check(ranks, ones, dev, ssd_launches) -> dict:
    """(l)'s training readings against (d)'s one-device run: every rank's
    losses the same and within TP_BF16_LOSS of it; one pod all-reduce of
    each ZeRO-1 block a step; SSD launches a rank = Mamba2 layers x its
    pieces a step (half the micro-batches) x 2 (forward and remat's
    recompute) x TP_STEPS on the card (added to ``ssd_launches``); each
    rank all the parameters (the pod axis splits rows only)."""
    key, arch, layers, cell, kw = POD_TRAIN
    rs = [r["pod_train"] for r in ranks]
    want = ones[key]["losses"]
    cfg = tp_cfg(arch, layers, dev, **kw)[0]
    diffs = [abs(a - b) for a, b in zip(rs[0]["losses"], want)]
    got = [r["launches"]["ssd_intra_chunk"] for r in rs]
    want_ssd = cfg.num_layers * rs[0]["pieces"] * 2 * TP_STEPS
    log(f"  ({cell}) {arch} at {cfg.num_layers} layers with ZeRO-1 on "
        f"({TP_RANKS}, 1, 1), each pod rank half the rows: losses "
        f"{rs[0]['losses']} against (d)'s one-device "
        f"{[round(x, 6) for x in want]} (max diff {max(diffs):.3e}); s/step "
        f"{spread(rs[0]['step_s'], 1.0)}; pod all-reduces a step "
        f"{rs[0]['pod_all_reduces_per_step']:.0f} ({rs[0]['leaves']} "
        f"leaves); SSD launches by rank {got} (want {cfg.num_layers} "
        f"layers x {rs[0]['pieces']} pieces x 2 x {TP_STEPS} = {want_ssd} "
        f"on the card); parameters "
        + ", ".join(f"{r['param_gib']:.3f}" for r in rs)
        + f" GiB by rank of {rs[0]['whole_param_gib']:.3f}, m and v "
        + ", ".join(f"{r['moments_gib']:.3f}" for r in rs)
        + " GiB; peak " + ", ".join(f"{r['peak_gib']:.2f}" for r in rs)
        + " GiB by rank")
    assert len(diffs) == TP_STEPS and max(diffs) < TP_BF16_LOSS, \
        (cell, rs[0]["losses"], want)
    assert all(r["losses"] == rs[0]["losses"] for r in rs), rs
    assert all(r["pod_all_reduces_per_step"] == r["leaves"] for r in rs), rs
    assert all(abs(r["param_gib"] - r["whole_param_gib"]) < 1e-9
               for r in rs), rs
    if dev.type == "cuda":
        assert got == [want_ssd] * TP_RANKS, (cell, got, want_ssd)
    ssd_launches[f"{arch} over pods ({TP_RANKS} gloo ranks)"] = sum(got)
    return {"ranks": rs, "max_loss_diff": max(diffs)}


def torch_load(path):
    import torch
    return torch.load(path, weights_only=False)


def serve_check(cfg, ref, got, ranks, dev, cell, pod=False) -> dict:
    """A served cell's readings against its one-device run: every rank's
    logits the same (replicated), each step's within SERVE_BF16_ULPS
    bf16 ulps of the largest one-device logit and the greedy token equal
    wherever the one-device top-2 gap exceeds twice that; flash launches
    = attention layers and SSD launches = Mamba2 layers a rank on the
    card (one prefill); the collectives of the prefill and of every step
    as ``serve_collectives`` counts them; each rank's parameters under
    the whole's (granite-8b under 51%: the norms are replicated; the
    Mamba2 blocks replicate B and C and their norms; ``pod``, the (2, 1,
    1) mesh of (l): all of them), its cache the bytes of its layout
    (``abstract_decode_state`` over the mesh), half of the whole's where
    nothing of it is replicated (granite-8b)."""
    V = cfg.vocab_size
    for r in got[1:]:
        assert all(bool((a == b).all()) for a, b in zip(r, got[0])), \
            f"{cell} {cfg.name}: the ranks' logits differ"
    worst, clear, agree = 0.0, 0, 0
    for i, (want, mine) in enumerate(zip(ref["logits"], got[0])):
        want, mine = want[..., :V], mine[..., :V]
        tol = SERVE_BF16_ULPS * 2.0 ** -8 * float(want.abs().max())
        err = float((mine - want).abs().max())
        worst = max(worst, err / tol)
        assert err <= tol, (cell, cfg.name, "logits", i, err, tol)
        top2 = want.topk(2, dim=-1).values
        wide = (top2[..., 0] - top2[..., 1]) > 2 * tol
        same = mine.argmax(-1) == want.argmax(-1)
        assert bool(same[wide].all()), (cell, cfg.name, "greedy", i)
        clear += int(wide.sum())
        agree += int(same.sum())
    want_colls = serve_collectives(cfg, pod)
    attn, mamba = serve_layers(cfg)
    for r in ranks:
        if dev.type == "cuda":
            assert r["flash_launches"] == attn, r
            assert r["ssd_launches"] == mamba, r
        assert tuple(r["prefill_collectives"]) == want_colls["prefill"], r
        assert all(tuple(c) == want_colls["step"]
                   for c in r["step_collectives"]), r
        if pod:
            assert abs(r["param_gib"] - r["whole_param_gib"]) < 1e-9, r
        else:
            assert r["param_gib"] < (0.51 if cfg.family == "dense"
                                     else 1) * r["whole_param_gib"], r
        assert r["cache_gib"] == r["layout_cache_gib"] < \
            r["whole_cache_gib"], r
        if cfg.family == "dense":
            assert abs(r["cache_gib"] * TP_RANKS
                       - r["whole_cache_gib"]) < 1e-9
    n = len(ref["logits"]) * SERVE_LANES
    mesh = f"({TP_RANKS}, 1, 1)" if pod else f"(1, {TP_RANKS})"
    log(f"  {cell} {cfg.name} at {cfg.num_layers} layers served over "
        f"{mesh}: prefill s by rank "
        + ", ".join(f"{r['prefill_s']:.3f}" for r in ranks)
        + "; s/step " + spread(ranks[0]["step_s"], 1.0)
        + f"; flash launches by rank {[r['flash_launches'] for r in ranks]}"
        f", SSD {[r['ssd_launches'] for r in ranks]}"
        f"; logits within {worst:.3f} of the {SERVE_BF16_ULPS}-ulp bound, "
        f"greedy equal {agree} of {n} ({clear} with a clear gap, all "
        f"equal); all-reduces, all-gathers a prefill "
        f"{ranks[0]['prefill_collectives']} and a step "
        f"{ranks[0]['step_collectives'][0]} (closed form "
        f"{want_colls['prefill']}, {want_colls['step']}); "
        f"parameters " + ", ".join(f"{r['param_gib']:.3f}" for r in ranks)
        + f" GiB by rank of {ranks[0]['whole_param_gib']:.3f}; cache "
        + ", ".join(f"{r['cache_gib']:.3f}" for r in ranks)
        + f" GiB by rank of {ranks[0]['whole_cache_gib']:.3f}; peak "
        + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks) + " GiB")
    return {"ranks": ranks, "worst_of_bound": worst, "greedy_equal": agree,
            "greedy_clear": clear, "lanes_x_steps": n,
            "collectives": want_colls}


# ------------------------------------------- phase 24: the cost analysis
# Phase 24: the port's cost analysis (``launch/hlo_analysis.py``) against
# the card.  (a) one real train step of phase 20's dense cell and of
# mamba2-780m at ANALYSIS_SSM_LAYERS layers (the SSD kernel on its path),
# each counted by a ``CostCounter`` on the card and traced again on meta
# tensors: FLOPs, bytes and kernel calls by name equal, the SSD kernel's
# launches equal its counted calls, and the trace's peak of live storage
# within ANALYSIS_PEAK_RATIO of the card's peak allocation for the step.
# (b) phase 23's cells (b) and (h) traced in a child process as rank 0 of
# a fake (1, TP_RANKS) group: their all-reduces equal phase 23's counts;
# (j)'s prefill and one decode step likewise, all-reduces and
# all-gathers; (l)'s, the same fake group laid out as (TP_RANKS, 1, 1):
# its training step's pod all-reduces, its prefill's and step's
# collectives.
ANALYSIS_SSM_LAYERS = 2
ANALYSIS_PEAK_RATIO = (0.75, 1.33)
ANALYSIS_CHILD_LIMIT_S = 120


def norm_model_reduces(dp) -> int:
    """All-reduces over the model group that ``DataParallel.norm`` makes
    (one for each of its two sums that holds a model-sharded leaf):
    collectives of the step that ``launch.sharding.all_reduces`` does not
    count."""
    return sum(1 for over_data in (False, True) if any(
        (dp.zero1 and d is not None) == over_data and md is not None
        for d, md in zip(dp.dims, dp.model_dims)))


def analysis_trace_child(cells, device_type, out_path):
    """Phase 24(b) in a child process: each ``(key, arch, layers, kw)``
    of ``cells`` cut as phase 23 cuts it on ``device_type``, traced on
    meta tensors as rank 0 of a fake (1, TP_RANKS) group; its all-reduces
    over the model group and ``launch.sharding``'s count of them, written
    to ``out_path``."""
    import torch
    from repro_torch.launch import dryrun, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model_zoo import DataParallel
    out = {}
    with dryrun.fake_world(TP_RANKS):
        mesh = make_mesh((1, TP_RANKS), ("data", "model"), device="cpu")
        for key, arch, layers, kw in cells:
            cfg, shape = tp_cfg(arch, layers, torch.device(device_type),
                                **kw)
            before = sharding.all_reduces
            counter, dt = dryrun.trace_cell(cfg, shape, mesh)
            out[key] = {
                "sharding_all_reduces": sharding.all_reduces - before,
                "model_all_reduces": sum(
                    1 for c in counter.collectives
                    if c.kind == "all-reduce" and c.group_size == TP_RANKS),
                "norm_model_all_reduces": norm_model_reduces(
                    DataParallel(cfg, mesh)),
                "collectives": H.collective_summary(counter.collectives),
                "trace_s": dt}
        out["serve"] = serve_trace(torch.device(device_type), mesh)
        out["serve_k"] = {key: serve_trace(torch.device(device_type), mesh,
                                           key) for key in SERVE_K}
        pod = make_mesh((TP_RANKS, 1, 1), POD_AXES, device="cpu")
        out["serve_l"] = serve_trace(torch.device(device_type), pod)
        _, arch, layers, _, kw = POD_TRAIN
        cfg, shape = tp_cfg(arch, layers, torch.device(device_type), **kw)
        before = sharding.all_reduces
        counter, dt = dryrun.trace_cell(cfg, shape, pod)
        out["pod_train"] = {
            "sharding_all_reduces": sharding.all_reduces - before,
            "pod_all_reduces": sum(
                1 for c in counter.collectives
                if c.kind == "all-reduce" and c.group_size == TP_RANKS),
            "collectives": H.collective_summary(counter.collectives),
            "trace_s": dt}
    Path(out_path).write_text(json.dumps(out))


def serve_trace(dev, mesh, key="j") -> dict:
    """Phase 24(b) for a served cell ((j), or one of (k)'s): its prefill
    and one decode step as ``dev`` cuts them, traced on meta tensors
    (rank 0's blocks) over ``mesh``: the all-reduces and all-gathers the
    trace sees and those ``launch.sharding`` counts, each."""
    import torch
    from repro_torch.launch import sharding
    from repro_torch.models import model_zoo as zoo
    cfg, pshape, dshape, _ = serve_cfg(dev, key)
    params = zoo.abstract_serving_params(cfg, mesh)

    def tokens(n):
        return torch.empty((SERVE_LANES, n), dtype=torch.int32,
                           device="meta")
    out = {}
    for key, fn, args in (
            ("prefill", zoo.make_prefill(cfg, pshape, mesh=mesh),
             (params, {"tokens": tokens(pshape.seq_len)})),
            ("step", zoo.make_serve_step(cfg, dshape, mesh=mesh),
             (params, zoo.abstract_decode_state(cfg, dshape, mesh),
              tokens(1)))):
        before = sharding.all_reduces, sharding.all_gathers
        counter = H.CostCounter()
        t0 = time.perf_counter()
        counter.run(fn, *args)
        out[key] = {
            "trace": [sum(1 for c in counter.collectives if c.kind == kind)
                      for kind in ("all-reduce", "all-gather")],
            "sharding": [sharding.all_reduces - before[0],
                         sharding.all_gathers - before[1]],
            "kernels": counter.kernels,
            "trace_s": time.perf_counter() - t0}
    return out


def analysis_step_check(arch, layers, dev) -> dict:
    """Phase 24(a) for one cell: a step on the card under a
    ``CostCounter`` against its meta trace."""
    import torch
    from repro_torch.launch.specs import abstract_batch
    from repro_torch.models import model_zoo as zoo
    from repro_torch.optim import adamw
    cfg, shape = train_cfg(arch, dev)
    if dev.type == "cuda":
        cfg = cfg.with_(num_layers=layers)
    release(dev)
    state = zoo.init_state(cfg, seed=0, device=dev)
    batch = zoo.make_batch(cfg, shape, seed=1, device=dev)
    step = zoo.make_train_step(cfg, adamw.HParams(**TRAIN_HP))
    step(state, batch)            # warm: cuBLAS's workspace, the kernels
    sync(dev)
    row = {"arch": arch, "layers": cfg.num_layers,
           "batch": [shape.global_batch, shape.seq_len]}
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        sync(dev)
        row["device_ms"] = start.elapsed_time(end)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    card = H.CostCounter()
    card.run(step, state, batch)
    sync(dev)
    launches = read_launches()
    trace = H.CostCounter()
    trace.run(step, zoo.abstract_state(cfg), abstract_batch(cfg, shape))
    terms = H.RooflineTerms(trace.flops, trace.bytes, 0.0)
    row.update(flops=trace.flops, bytes=trace.bytes, kernels=trace.kernels,
               card_flops=card.flops, card_bytes=card.bytes,
               card_kernels=card.kernels, launches=launches,
               t_compute_ms=terms.t_compute * 1e3,
               t_memory_ms=terms.t_memory * 1e3,
               trace_peak=trace.peak)
    log(f"  {arch} at {cfg.num_layers} layers, batch {shape.global_batch}"
        f" x {shape.seq_len}: card {card.flops} flop, {card.bytes} B, "
        f"kernels {card.kernels}; meta trace {trace.flops} flop, "
        f"{trace.bytes} B, kernels {trace.kernels}; launches {launches}")
    assert (card.flops, card.bytes, card.kernels) == \
        (trace.flops, trace.bytes, trace.kernels), row
    calls = trace.kernels.get("ssd_intra_chunk", {}).get("calls", 0)
    assert launches["ssd_intra_chunk"] == (calls if dev.type == "cuda"
                                           else 0), row
    if dev.type == "cuda":
        # the step's own peak: the allocator's, less what was live
        # beside its arguments
        row["card_peak"] = (torch.cuda.max_memory_allocated(dev)
                            - (base - card.argument_bytes))
        row["peak_ratio"] = trace.peak / row["card_peak"]
        ms = row["device_ms"]
        log(f"  peak: trace {trace.peak / 2**30:.3f} GiB, card "
            f"{row['card_peak'] / 2**30:.3f} GiB (ratio "
            f"{row['peak_ratio']:.4f}, held to {ANALYSIS_PEAK_RATIO}); "
            f"device {ms:.2f} ms a step against t_compute "
            f"{row['t_compute_ms']:.2f} ms ({row['t_compute_ms'] / ms:.1%})"
            f" and t_memory {row['t_memory_ms']:.2f} ms "
            f"({row['t_memory_ms'] / ms:.1%}), datasheet constants")
        lo, hi = ANALYSIS_PEAK_RATIO
        assert lo <= row["peak_ratio"] <= hi, row
    del state, batch, card, trace
    release(dev)
    return row


def analysis_phase(dev, zero1, tp) -> dict:
    """Phase 24.  ``zero1``: phase 22(b)'s setting, as phase 23(b) ran;
    ``tp``: phase 23's numbers, whose (b) and (h) all-reduce counts the
    child's traces must equal."""
    import multiprocessing
    import tempfile
    log(f"[analysis] phase 24 on "
        f"{gpu_line() if dev.type == 'cuda' else dev}")
    cells = [("dense", DENSE_TRAIN_ARCH, DENSE_TRAIN_LAYERS,
              {"zero1": zero1}),
             *((k, a, n, kw) for k, a, n, _, kw in ONE_DEVICE_TP
               if k == "moe_grouped")]
    numbers = {}
    with tempfile.TemporaryDirectory() as tmp:
        out_path = Path(tmp) / "analysis.json"
        child = multiprocessing.get_context("spawn").Process(
            target=analysis_trace_child,
            args=(cells, dev.type, str(out_path)))
        child.start()            # (b) on the host while (a) runs
        try:
            log("[analysis] (a) a train step on the card against its meta "
                "trace")
            numbers["steps"] = [
                analysis_step_check(DENSE_TRAIN_ARCH, DENSE_TRAIN_LAYERS,
                                    dev),
                analysis_step_check(TRAIN_ARCH, ANALYSIS_SSM_LAYERS, dev)]
            child.join(ANALYSIS_CHILD_LIMIT_S)
        finally:
            if child.is_alive():
                child.kill()
                child.join()
        assert child.exitcode == 0, \
            f"phase 24(b): the child's exit code {child.exitcode}"
        traced = json.loads(out_path.read_text())
    log(f"[analysis] (b) phase 23's cells traced as rank 0 of a fake (1, "
        f"{TP_RANKS}) group")
    for key, arch, layers, _ in cells:
        got, want = traced[key], tp[key]["ranks"][0]["all_reduces_per_step"]
        log(f"  {key} ({arch}, {layers} layers): trace "
            f"{got['model_all_reduces']} all-reduces over the model group "
            f"({got['sharding_all_reduces']} through launch.sharding, "
            f"{got['norm_model_all_reduces']} from DataParallel.norm); "
            f"phase 23 read {want:.0f} a step; {got['trace_s']:.1f} s to "
            f"trace; {json.dumps(got['collectives'])}")
        assert got["sharding_all_reduces"] == want, (key, got, want)
        assert got["model_all_reduces"] == got["sharding_all_reduces"] + \
            got["norm_model_all_reduces"], (key, got)
    served = traced.pop("serve")
    served_k = traced.pop("serve_k")
    served_l = traced.pop("serve_l")
    pod_train = traced.pop("pod_train")
    want = tp["pod"]["train"]["ranks"][0]["pod_all_reduces_per_step"]
    log(f"  (l) {POD_TRAIN[1]}'s step on ({TP_RANKS}, 1, 1) traced: "
        f"{pod_train['sharding_all_reduces']} pod all-reduces through "
        f"launch.sharding, {pod_train['pod_all_reduces']} all-reduces over "
        f"{TP_RANKS} ranks in all (and the metrics' mean); phase 23 read "
        f"{want:.0f} a step; {pod_train['trace_s']:.1f} s to trace; "
        f"{json.dumps(pod_train['collectives'])}")
    assert pod_train["sharding_all_reduces"] == want, (pod_train, want)
    assert pod_train["pod_all_reduces"] == want + 1, pod_train
    for cell, key, got_cell, ranks in (
            ("(j)", "j", served, tp["serve"]["ranks"]),
            *(("(k)", k, served_k[k], tp["serve_k"][k]["ranks"])
              for k in SERVE_K),
            ("(l)", "j", served_l, tp["pod"]["serve"]["ranks"])):
        for kind, want in (("prefill", ranks[0]["prefill_collectives"]),
                           ("step", ranks[0]["step_collectives"][0])):
            got = got_cell[kind]
            log(f"  {cell} {SERVE_MODELS[key][0]}'s {kind} traced: "
                f"all-reduces, all-gathers {tuple(got['trace'])} "
                f"(launch.sharding {tuple(got['sharding'])}); the ranks "
                f"counted {tuple(want)} on the card; kernels "
                f"{got['kernels']}; {got['trace_s']:.1f} s to trace")
            assert list(got["trace"]) == list(got["sharding"]) == \
                list(want), (cell, key, kind, got, want)
    numbers["traced"] = dict(traced, pod_train=pod_train)
    numbers["serve_traced"] = dict(served_k, j=served, l=served_l)
    return numbers


# phase 7's float32 recurrent decode chain at full width: mamba2-780m cut
# to F32_CHAIN layers, zamba2-2.7b to one period (6 Mamba2 layers and the
# shared attention); 10 tokens fed one serve step at a time
F32_CHAIN, F32_CHAIN_TOKENS, F32_CHAIN_TOL = 2, 10, 1e-5


def recurrent_chain(cfg, params, toks, dev, paged, conv_dtype=None):
    """``toks`` (B, T) fed one serve step at a time from an empty dense or
    paged state (``conv_dtype``: the conv leaf in another dtype than the
    port's); the (B, T, vocab_size) float32 logits (the padded columns,
    masked to -1e30, left out)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model_zoo as zoo
    B, T = toks.shape
    shape = ShapeConfig("chain", 16 * ((T + 15) // 16), B, "decode")
    if paged:
        bs, mb = 16, shape.seq_len // 16
        state = zoo.init_paged_decode_state(cfg, shape, bs, B * mb, dev)
        state.block_tables.copy_(torch.arange(
            B * mb, dtype=torch.int32, device=dev).view(B, mb))
        step = zoo.make_paged_serve_step(cfg, shape, bs, B * mb)
    else:
        state = zoo.init_decode_state(cfg, shape, fill_len=0, device=dev)
        step = zoo.make_serve_step(cfg, shape)
    if conv_dtype is not None:
        state.cache["conv"] = state.cache["conv"].to(conv_dtype)
    active = torch.ones(B, dtype=torch.int32, device=dev)
    outs = []
    with torch.no_grad():
        for t in range(T):
            logits, state = step(params, state, toks[:, t:t + 1], active)
            outs.append(logits[:, 0, :cfg.vocab_size].float())
    return torch.stack(outs, dim=1)


def recurrent_f32_phase(dev) -> dict:
    """Phase 7's float32 recurrent decode check at full width: each chain
    against the forward, ``make_prefill`` of every prefix (the SSD kernel
    on the card), as the largest difference over the largest logit; the
    dense chain again on a bf16 conv leaf, the state before the leaf
    followed the compute dtype, is the reading before the repair."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.models import model_zoo as zoo
    out = {}
    for arch in ("mamba2-780m", "zamba2-2.7b"):
        cfg = get_config(arch)
        layers = F32_CHAIN if cfg.family == "ssm" else cfg.attn_every
        cfg = cfg.with_(num_layers=layers, compute_dtype="float32")
        params = zoo.init_serving_params(cfg, seed=0, device=dev)
        gen = torch.Generator().manual_seed(7)
        toks = torch.randint(0, cfg.vocab_size, (2, F32_CHAIN_TOKENS),
                             generator=gen, dtype=torch.int32).to(dev)
        sk.launches = 0
        with torch.no_grad():
            fwd = torch.stack([zoo.make_prefill(cfg, ShapeConfig(
                "p", t, 2, "prefill"))(params, {"tokens": toks[:, :t]})[0][
                    :, 0, :cfg.vocab_size].float()
                for t in range(1, F32_CHAIN_TOKENS + 1)], dim=1)
        ssd_launches = sk.launches
        top = float(fwd.abs().max())
        rel = {}
        for name, paged, conv in (("dense", False, None),
                                  ("paged", True, None),
                                  ("dense, bf16 conv leaf", False,
                                   torch.bfloat16)):
            dec = recurrent_chain(cfg, params, toks, dev, paged, conv)
            assert torch.isfinite(dec).all(), (arch, name)
            rel[name] = float((dec - fwd).abs().max()) / top
        log(f"[f32 chain] {arch} at {layers} layers, d {cfg.d_model}, "
            f"float32, {F32_CHAIN_TOKENS} steps vs make_prefill of each "
            f"prefix ({ssd_launches} SSD launches): decode vs forward "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
            + f" of the largest logit {top:.4f} (the bf16 conv leaf: "
            f"before the repair)")
        if cfg.family == "ssm":
            for name in ("dense", "paged"):
                assert rel[name] < F32_CHAIN_TOL, (arch, name, rel[name])
        out[arch] = {"layers": layers, "ssd_launches": ssd_launches, **rel}
        del params
        torch.cuda.empty_cache()
    return out


# phase 25: the examples; the spot-elastic fleet's ranks share the card
EXAMPLE_RANKS, EXAMPLE_STEPS, EXAMPLE_SPAWN_LIMIT_S = 4, 6, 300
EXAMPLE_JACOBI_LAUNCHES = 4 * 12 * 4     # odf 1, 2, 4, 8 x 12 iters x 4 PEs


def example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(dev) -> dict:
    """Each example's ``main`` on the card, held to what its original
    holds; returns each one's seconds and the Jacobi kernel's launches
    in the stencil example."""
    import math
    import torch
    from repro_torch.cluster import ROUTERS
    from repro_torch.kernels.jacobi import kernel as jk
    secs = {}

    def run(name, argv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = example(name).main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        log(f"[examples] {name} {' '.join(argv)}: {secs[name]:.2f} s")
        return out

    out = run("torch_serve", [])
    assert out["stats"]["tokens"] == 48, out["stats"]
    assert all(r.done and len(r.out_tokens) == 8 for r in out["requests"])
    outs = run("torch_serve_cluster", [])
    assert set(outs) == set(ROUTERS)
    assert all(o["dropped"] == 0 and o["completed"] == 20
               for o in outs.values()), outs
    jk.launches = 0
    lines = run("torch_jacobi_overdecomp", [])
    jacobi_launches = jk.launches
    assert len(lines) == 7, lines
    assert jacobi_launches == EXAMPLE_JACOBI_LAUNCHES, jacobi_launches
    out = run("torch_quickstart", [])
    assert out["final_loss"] < 6.5, out
    rec = run("torch_train_spot_elastic", [
        "--n-devices", str(EXAMPLE_RANKS), "--steps", str(EXAMPLE_STEPS),
        "--timeout", str(EXAMPLE_SPAWN_LIMIT_S)])
    assert [tuple(r) for r in rec["rescales"]] == [
        ("shrink", EXAMPLE_RANKS, EXAMPLE_RANKS - 2),
        ("expand", EXAMPLE_RANKS - 2, EXAMPLE_RANKS)], rec
    assert rec["steps"] == list(range(EXAMPLE_STEPS)), rec
    assert all(math.isfinite(x) for x in rec["losses"]), rec
    return {"seconds": secs, "jacobi_launches": jacobi_launches,
            "spot_elastic_losses": rec["losses"]}


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
        "at granite-8b and zamba2-2.7b shapes, S=8704 at the "
        "seamless-m4t-medium encoder's and internvl2-26b's)")
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
    # 16384-token prefill, kernel vs plain (cut to LONG_PARITY_LAYERS)
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
        cut = LONG_PARITY_LAYERS[arch]
        stack, n = (("mamba", cut // cfg.attn_every)
                    if cfg.family == "hybrid" else ("layers", cut))
        cfg, params = (cfg.with_(num_layers=cut),
                       dict(params, **{stack: params[stack][:n]}))
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
    f32_chain = recurrent_f32_phase(dev)
    log(f"[f32 chain] numbers {json.dumps(f32_chain)}")
    t_phase = lap("phase 7 (reduced float32 parity, float32 recurrent "
                  "chain)", t_phase)

    # 17. work-unit migration on the card, full width
    migrated, migration = migration_phase(dev)
    by_path.update(migrated)
    log(f"[migrate] numbers {json.dumps(migration)}")
    t_phase = lap("phase 17 (migration)", t_phase)

    # 18. the serving cluster on the card, full width; 19. market and
    # vertical A/Bs over the same params; then the launcher's three modes
    cfg = get_config(CLUSTER_ARCH).with_(num_layers=CLUSTER_LAYERS)
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
        "paged_attention": single_launcher_run(MOE_ARCH, MOE_LAUNCH_LAYERS,
                                               dev),
        "ssd_intra_chunk": 0}
    launches, out, wall, peak = launcher_run(
        "moe cluster launcher", LAUNCHES[0][1], dev, MOE_ARCH,
        MOE_LAUNCH_LAYERS)
    by_path[f"{MOE_ARCH} cluster launcher"] = {"paged_attention": launches,
                                               "ssd_intra_chunk": 0}
    log(f"  moe cluster launcher: wall {wall:.2f} s, peak {peak:.2f} GiB, "
        f"summary {json.dumps(out)}")
    t_phase = lap("phase 19 and the launchers", t_phase)

    # 20. training: the SSD Function, mamba2-780m across a rescale and its
    # twin, kernel route against plain, granite-8b cut in depth
    trained, training = training_phase(dev, flush)
    by_path.update(trained)
    ssd["training"] = training
    log(f"[train] numbers {json.dumps(training)}")
    t_phase = lap("phase 20 (training)", t_phase)
    # 21. the enc_dec and vlm families at full width
    prefilled, frontend = frontend_phase(dev)
    flash["launches_by_path"].update(prefilled)
    flash["launches"] = sum(flash["launches_by_path"].values())
    log(f"[frontend] numbers {json.dumps(frontend)}")
    t_phase = lap("phase 21 (enc_dec and vlm)", t_phase)
    # 22. data-parallel training over torch.distributed ranks
    dp_runs, dp = dp_phase(dev, training["mamba2"]["twin"]["losses"])
    by_path.update(dp_runs)
    log(f"[dp] numbers {json.dumps(dp)}")
    t_phase = lap("phase 22 (data parallel)", t_phase)
    # 23. the model axis: the SPMD stencil, tensor and expert parallelism
    spmd_launches, tp_ssd, tp = tp_phase(dev, dp["gloo"]["zero1"],
                                         dp["gloo"]["twin_losses"])
    by_path.update({k: {"paged_attention": 0, "ssd_intra_chunk": v}
                    for k, v in tp_ssd.items()})
    ssd["at_tensor_parallel_heads"] = tp["ssd_at_rank_heads"]
    flash["at_tensor_parallel_heads"] = tp["flash_at_rank_heads"]
    if tp["serve_k_checks"]:
        ssd["at_serving_rank_heads"] = tp["serve_k_checks"]["ssd"]
        flash["at_hybrid_serving_rank_heads"] = tp["serve_k_checks"]["flash"]
    for key, served, mesh in (
            ("j", tp["serve"], f"(1, {TP_RANKS})"),
            *((k, tp["serve_k"][k], f"(1, {TP_RANKS})") for k in SERVE_K),
            ("j", tp["pod"]["serve"], f"({TP_RANKS}, 1, 1)")):
        what = (f"{SERVE_MODELS[key][0]} prefill over {mesh} "
                f"({TP_RANKS} gloo ranks)")
        flash["launches_by_path"][what] = sum(
            r["flash_launches"] for r in served["ranks"])
        by_path[what] = {"paged_attention": 0, "ssd_intra_chunk": sum(
            r["ssd_launches"] for r in served["ranks"])}
    flash["launches_by_path"] = {k: v for k, v in
                                 flash["launches_by_path"].items() if v}
    flash["launches"] = sum(flash["launches_by_path"].values())
    log(f"[tp] numbers {json.dumps(tp)}")
    t_phase = lap("phase 23 (model axis)", t_phase)
    # 24. the cost analysis: a step on the card against its meta trace,
    # phase 23's all-reduces against a fake group's trace
    analysis = analysis_phase(dev, dp["gloo"]["zero1"], tp)
    log(f"[analysis] numbers {json.dumps(analysis)}")
    log("[analysis] summary: card and meta trace agree (FLOPs, bytes, "
        "kernel calls) for " + ", ".join(
            f"{r['arch']} x{r['layers']} (peak ratio "
            f"{r['peak_ratio']:.3f}, device {r['device_ms']:.1f} ms, "
            f"t_compute {r['t_compute_ms']:.1f}, t_memory "
            f"{r['t_memory_ms']:.1f})" for r in analysis["steps"])
        + "; all-reduces equal phase 23's: " + ", ".join(
            f"{k} {v['sharding_all_reduces']}"
            for k, v in analysis["traced"].items())
        + "; (j)'s, (k)'s and (l)'s collectives equal the ranks': "
        + ", ".join(
            f"{c} {k} {tuple(v['trace'])}"
            for c, cell in analysis["serve_traced"].items()
            for k, v in cell.items()))
    t_phase = lap("phase 24 (cost analysis)", t_phase)
    for record, key in ((paged, "paged_attention"), (ssd, "ssd_intra_chunk")):
        record["launches_by_path"] = {a: c[key] for a, c in by_path.items()
                                      if c[key]}
        record["launches"] = sum(record["launches_by_path"].values())

    # 16. the same at a bucket past 8192
    small_long_parity(dev)
    t_phase = lap("phase 16 (long-bucket parity)", t_phase)

    # 10-12. the stencil app: C1 and C2, correctness, the event driver
    by_run = {"steady window": steady_launches, **stencil_app_phase(dev),
              f"spmd stencil ({TP_RANKS} gloo ranks)": spmd_launches}
    stencil_checks_phase(dev)
    by_run["driver"] = stencil_driver_phase(dev)
    t_phase = lap("phases 10-12 (stencil app)", t_phase)

    # 25. the five examples on the card
    examples = examples_phase(dev)
    log(f"[examples] numbers {json.dumps(examples)}")
    by_run["jacobi_overdecomp example"] = examples["jacobi_launches"]
    jac["launches_by_path"] = by_run
    jac["launches"] = sum(by_run.values())
    lap("phase 25 (examples)", t_phase)

    log(f"[total] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": [paged, ssd, flash, jac]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
