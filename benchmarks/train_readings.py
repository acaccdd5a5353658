#!/usr/bin/env python3
"""Phase 20 of ``chip_smoke.py`` alone on one NVIDIA GPU: training.

    python3 benchmarks/train_readings.py

It builds only ``csrc/ssd.cu`` and runs ``chip_smoke.training_phase``:
the SSD kernel under autograd at mamba2-780m's and zamba2-2.7b's
training chunks (outputs and input gradients against the plain
version, the forward kernel's and the backward's ms), full-width
mamba2-780m trained across a rescale beside a twin (losses, s/step,
tokens/s, peak GiB, the rescale stages by store, SSD launches), one
step's gradient through the kernel against the plain route in bf16 and
float32, and granite-8b at 2 layers with the launcher, all with
``chip_smoke.py``'s limits.  Then one mamba2-780m step of (b) under
``torch.profiler``: its wall time, the device time summed over its
kernels by family (GEMMs, the SSD kernel, the rest) and the top
kernels.  The card's name and power limit come first, the phase's
numbers as one JSON line last.  Without a card it exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_family(name: str) -> str:
    low = name.lower()
    if "ssd" in low:
        return "ssd kernel"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "gemm"
    return "other"


def profile_step(cs, dev) -> dict:
    """One mamba2-780m training step of phase 20 (b) under the profiler,
    after two warm steps: wall s, device ms summed by kernel family, the
    top kernels."""
    import torch
    from repro_torch.launch.train import ElasticTrainer
    from repro_torch.optim import adamw
    cfg, shape = cs.train_cfg(cs.TRAIN_ARCH, dev)
    tr = ElasticTrainer(cfg, shape, seed=0, hp=adamw.HParams(**cs.TRAIN_HP),
                        device=dev)
    tr.train(2, log_every=0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.train(1, log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    by_family = {}
    for ms, n, name in rows:
        fam = kernel_family(name)
        by_family[fam] = by_family.get(fam, 0.0) + ms
    busy = sum(by_family.values())
    print(f"[profile] one step: wall {wall:.3f} s, device kernels "
          f"{busy:.1f} ms summed ({busy / 1e3 / wall:.1%} of wall); "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
              by_family.items(), key=lambda kv: -kv[1])), flush=True)
    for ms, n, name in rows[:20]:
        print(f"  {ms:9.2f} ms {n:6d} x  {name[:110]}", flush=True)
    return {"wall_s": wall, "device_ms": busy, "by_family_ms": by_family,
            "top": [(name[:110], n, ms) for ms, n, name in rows[:20]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_readings: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    print(cs.gpu_line(), flush=True)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    build.compile_all(["ssd"])
    print(f"[build] ssd in {time.perf_counter() - t0:.1f} s", flush=True)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    t0 = time.perf_counter()
    runs, numbers = cs.training_phase(dev, flush_buf.zero_)
    print(f"[time] phase 20: {time.perf_counter() - t0:.1f} s", flush=True)
    cs.release(dev)
    numbers["profile"] = profile_step(cs, dev)
    print(json.dumps({"launches": runs, "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
