#!/usr/bin/env python3
"""Where a decode step of the port's paged engine spends its time, on one
NVIDIA GPU.

    python3 benchmarks/torch_profile.py [--arch granite-8b] [--layers N]
                                        [--steps 8]

Builds ``--arch`` (``granite-8b``, ``mamba2-780m``, ``zamba2-2.7b`` or
``qwen2-moe-a2.7b``) at its published width (depth ``--layers``, the published depth by
default) with random bf16 weights from seed 0, and a
``ServingEngine(cache_mode="paged", batch_size=8, max_seq=1024,
block_size=16)`` of ``repro_torch``.  It admits 8 requests of 500 prompt
tokens (64 new each), decodes two windows to reach a steady state, then
over steady windows of ``--steps`` fused decode steps reports:

* the host's wall time per step (``perf_counter`` around ``step_many``,
  synchronised), without the profiler;
* under ``torch.profiler`` (CPU and CUDA activities): the device's busy
  time per step (the union of the kernels' intervals), its share of the
  unprofiled wall time, kernel launches per step, the paged-attention
  kernel's time per launch and per step (where the model has attention),
  and the kernels that take the most device time;
* the step's least time on the card: the weights (bf16; norms, Mamba2's
  ``A_log``/``dt_bias`` and the MoE router float32), each read once (the
  MoE block multiplies every expert), the KV rows the lanes read, and
  the recurrent state (float32 SSD state, bf16 conv tail) each layer
  reads and writes back, over 3.35 TB/s.

The card's name and power limit come first; the last line is one JSON
object with every number.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet


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


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b",
                    choices=("granite-8b", "mamba2-780m", "zamba2-2.7b",
                             "qwen2-moe-a2.7b"))
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the published one)")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.checkpointing import tree_leaves
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.models import model_zoo as zoo
    from repro_torch.serving.engine import Request, ServingEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.with_(num_layers=args.layers)
    # paged-attention launches per decode step
    attn_layers = (cfg.num_layers if cfg.family in ("dense", "moe") else
                   cfg.num_layers // cfg.attn_every
                   if cfg.family == "hybrid" else 0)
    params = zoo.init_serving_params(cfg, seed=0, device="cuda")
    engine = ServingEngine(cfg, params, batch_size=8, max_seq=1024,
                           block_size=16, cache_mode="paged", device="cuda")
    rng = np.random.default_rng(0)
    for i in range(8):
        engine.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 500).astype(np.int32), max_new_tokens=64))
    n = args.steps
    engine.step_many(n)                # admit (prefill) + first window
    engine.step_many(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step_many(n)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n

    launches0 = kernel.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step_many(n)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n
    assert kernel.launches - launches0 == attn_layers * n
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in kernels]) / 1e3 / n
    # the wrapper's launches: one device kernel each, which merges its own
    # chunks
    pa_n = kernel.launches - launches0
    pa_us = sum(v[0] for k, v in by_name.items() if "paged_attention" in k)
    pa_kernels = sum(v[1] for k, v in by_name.items()
                     if "paged_attention" in k)
    if kernels:
        assert pa_kernels == pa_n, (pa_kernels, pa_n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]

    kv_rows = int(engine.state.cache_len.sum())      # after the window
    weight_bytes = sum(t.nbytes for t in tree_leaves(params))
    kv_bytes = kv_rows * attn_layers * cfg.num_kv_heads * cfg.head_dim * 4
    state_bytes = sum(2 * t.numel() * t.element_size()   # read + write
                      for k, t in engine.state.cache.items()
                      if k in ("ssm", "conv"))
    bound_ms = ((weight_bytes + kv_bytes + state_bytes) / HBM_BYTES_PER_S
                * 1e3)
    result = {
        "device": torch.cuda.get_device_name(0), "card": card,
        "arch": cfg.name, "layers": cfg.num_layers, "lanes": 8, "steps": n,
        "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_profiled": prof_wall_ms,
        "device_busy_ms_per_step": busy_ms if kernels else None,
        # busy time from the profiled window over the wall time of the
        # unprofiled one (the profiler slows the host, not the kernels)
        "device_busy_share": busy_ms / wall_ms if kernels else None,
        "kernel_launches_per_step": len(kernels) / n,
        "paged_attention_us_per_launch": pa_us / pa_n if pa_n else None,
        "paged_attention_device_kernels_per_launch":
            pa_kernels / pa_n if pa_n and kernels else None,
        "paged_attention_ms_per_step": pa_us / 1e3 / n if pa_n else None,
        "bound_ms_per_step": bound_ms,
        "decode_tok_per_s": 8 * 1e3 / wall_ms,
        "top_kernels_ms_per_step": [
            [name[:90], us / 1e3 / n, cnt / n] for name, (us, cnt) in top],
    }
    for name, ms, cnt in result["top_kernels_ms_per_step"]:
        print(f"  {ms:8.3f} ms/step  {cnt:6.1f}/step  {name}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
