#!/usr/bin/env python3
"""How far the bf16 paged-attention kernel lands from its plain version,
on one NVIDIA GPU: the readings its limits in ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` were set from.

    python3 benchmarks/paged_bf16_readings.py

The plain version rounds the softmax weights to bf16 before p.v (as the
reference does) and the kernel keeps them to 2^-16, so an output differs
by a share of its (lane, head) row's size.  For ``chip_smoke.py``'s
paged phase (granite-8b and zamba2-2.7b decode shapes) and for the cuda
tests' shapes (seeds 0-2), it prints the largest
``(|diff| - 2^-7 |ref|) / row RMS`` (what an element takes beyond one
bf16 ulp of itself, against the RMS of its row) and the relative L2 of
the whole output.  The card's name and power limit come first.  Without
a card it exits non-zero.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]


def readings(out, ref):
    """(largest excess over one ulp as a share of its row's RMS, rel L2)."""
    a, b = out.float(), ref.float()
    rms = b.pow(2).mean(-1, keepdim=True).sqrt()
    excess = ((a - b).abs() - 2.0 ** -7 * b.abs()) / rms
    return float(excess.max()), float((a - b).norm() / b.norm())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_bf16_readings: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from chip_smoke import paged_phase_inputs
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from test_torch_cuda import paged_inputs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cases = [(f"chip_smoke phase H={h} KV={kv} D={d}",
              paged_phase_inputs(dev, h, kv, d))
             for h, kv, d in ((32, 8, 128), (32, 32, 80))]
    for shape in ((3, 4, 4, 16, 8, 12, 4, 3), (3, 8, 2, 16, 8, 12, 4, 4),
                  (8, 32, 8, 128, 16, 200, 20, 20),
                  (2, 8, 8, 64, 4, 40, 10, 7),
                  (4, 32, 32, 80, 16, 64, 16, 16)):
        for seed in (0, 1, 2):
            q, k, v, bt, kl = [torch.from_numpy(a).to(dev)
                               for a in paged_inputs(*shape, seed=seed)]
            cases.append((f"test {shape} seed {seed}",
                          (q.bfloat16(), k.bfloat16(), v.bfloat16(), bt, kl)))
    for what, args in cases:
        out = kernel.paged_attention(*args)
        excess, rel = readings(out, paged_attention_ref(*args))
        print(f"{what}: excess over one ulp / row RMS {excess:.3e}, "
              f"rel_l2 {rel:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
