#!/usr/bin/env python3
"""The SSD intra-chunk kernel alone on one NVIDIA GPU: build, check, time.

    python3 benchmarks/ssd_readings.py [--tree DIR]

It builds only ``csrc/ssd.cu``, prints ``ptxas``'s registers and spills
of each instantiation, then, at every shape of ``chip_smoke.py``'s SSD
phase (the main path's chunk prefills of mamba2-780m and zamba2-2.7b at
l = 16, 64 and 256, and zamba2-2.7b's 16384-token prefill at b * nc =
64), holds the kernel to its plain version with ``chip_smoke.py``'s
limits and on the same inputs (``chip_smoke.ssd_phase_inputs``), prints
how far the kernel and the plain float32 version each land from the
plain version in float64 (relative L2 of y and of the state), and times
the kernel cold (L2 flushed) and warm, beside an empty kernel launched
through the same ctypes path.  The card's name and power limit come
first.  Without a card it exits non-zero.

``--tree DIR`` times the kernel of another checkout of this repository
(its ``src/``, built into its own ``build/``), on this checkout's
inputs and limits: two versions compared in one call.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose kernel is timed (default: this)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_readings: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # the timed tree's package first: chip_smoke (this checkout) then
    # finds repro_torch already imported
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import kernel, ssd_intra_chunk_ref
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"kernel of {args.tree.resolve()}: {build.CSRC / 'ssd.cu'}")
    build.compile_all(["ssd"])
    for name, (regs, st, ld) in sorted(cs.ptxas_report(
            build.build_log.get("ssd", {}).get("ptxas", "")).items()):
        print(f"ptxas {name}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B")
    dev = torch.device("cuda")
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    if hasattr(kernel, "empty_launch"):
        cold, warm = cs.empty_launch_ms(dev, flush)
        print(f"empty launch: {cold:.4f} ms cold, {warm:.4f} ms warm")
    for model, bc, l, (h, p, n) in cs.SSD_SHAPES:
        inputs = cs.ssd_phase_inputs(dev, bc, l, h, p, n, seed=l + bc)
        err = cs.ssd_check(inputs, f"{model} b*nc={bc} l={l}")
        y64, st64 = ssd_intra_chunk_ref(*[t.double() for t in inputs])
        far = []
        for out in (kernel.ssd_intra_chunk(*inputs),
                    ssd_intra_chunk_ref(*inputs)):
            far += [float((a.double() - b).norm() / b.norm())
                    for a, b in zip(out, (y64, st64))]
        del y64, st64
        print(f"{model} b*nc={bc} l={l}: relative L2 from float64, kernel y "
              f"{far[0]:.3e} state {far[1]:.3e}; plain float32 y "
              f"{far[2]:.3e} state {far[3]:.3e}")
        ms = cs.cuda_ms(lambda: kernel.ssd_intra_chunk(*inputs), 50, flush)
        warm_ms = cs.cuda_ms(lambda: kernel.ssd_intra_chunk(*inputs), 50)
        flops, _, bound_ms, ffma_ms = cs.ssd_bound(l, h, p, n, bc)
        print(f"{model} b*nc={bc} l={l}: {ms:.4f} ms cold, {warm_ms:.4f} ms "
              f"warm; bound {bound_ms:.5f} ms (3xTF32), FFMA bound "
              f"{ffma_ms:.5f} ms; {flops / ms / 1e9:.2f} TFLOP/s; max abs "
              f"err {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
