#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` alone on one NVIDIA GPU: the model axis.

    python3 benchmarks/tp_readings.py

It builds only ``csrc/jacobi.cu`` and ``csrc/ssd.cu``, runs phase 22(b)
(``chip_smoke.dp_gloo_phase``: two gloo ranks sharing the card train
granite-8b at full width and ``DENSE_TRAIN_LAYERS`` layers with ZeRO-1
across 2 -> 1 -> 2 beside an unrescaled twin), then phase 23
(``chip_smoke.tp_phase``): two gloo ranks run the SPMD Jacobi stencil at
16384^2 against the single-grid kernel, granite-8b tensor parallel on a
(1, 2) mesh against phase 22(b)'s twin, qwen2-moe-a2.7b with explicit
expert parallelism on (1, 2) against a one-device run with
``moe_groups=1``, and mamba2-780m (2 layers) and zamba2-2.7b (one
period, 6 Mamba2 layers) tensor parallel on (1, 2), the SSD kernel on
each rank's heads, and seamless-m4t-medium (1 encoder + 1 decoder
layer) and internvl2-26b (1 layer) tensor parallel on (1, 2), and
qwen2-moe-a2.7b with the grouped dispatch (its 16 routing groups, 30
experts a rank) on (1, 2), and qwen2-moe-a2.7b at 1 layer with the
one-hot dispatch on (2, 1) (2-row micro-batches routed across both data
ranks), against one-device runs of the same cuts, and the pod axis
((l): mamba2-780m with ZeRO-1 and granite-8b served on a (2, 1, 1)
``("pod", "data", "model")`` mesh against the same one-device runs),
all with
``chip_smoke.py``'s limits: losses, s/step (one device and the mesh),
peak GiB a rank, model-axis all-reduces and routing all-gathers a
step.  The card's name and power limit come first,
the phase's numbers as one JSON line last.  Without a card it exits
non-zero.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_readings: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    print(cs.gpu_line(), flush=True)
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    build.compile_all(["jacobi", "ssd"])
    print(f"[build] jacobi, ssd in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    gloo = cs.dp_gloo_phase(dev)
    print(f"[time] phase 22(b): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches, ssd_launches, numbers = cs.tp_phase(dev, gloo["zero1"],
                                                  gloo["twin_losses"])
    print(f"[time] phase 23: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"spmd_launches": launches,
                      "ssd_launches": ssd_launches, "numbers": numbers}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
