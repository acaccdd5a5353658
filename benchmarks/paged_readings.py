#!/usr/bin/env python3
"""The paged-attention decode kernel alone on one NVIDIA GPU: build,
check, time.

    python3 benchmarks/paged_readings.py [--tree DIR]

It builds only ``csrc/paged_attention.cu`` and prints ``ptxas``'s
registers and spills and the tensor-core instructions (``HMMA``) of each
instantiation.  Then, at granite-8b's
decode shapes (H 32, KV 8, D 128) and zamba2-2.7b's shared attention (H
32, KV 32, D 80), for each lane mix of ``chip_smoke.PAGED_MIXES`` (the
skewed mix of ``chip_smoke.py``'s paged phase, 8 lanes of 500 positions,
one lane of 1000) on ``chip_smoke.paged_phase_inputs``, it holds the
kernel to its plain version with ``chip_smoke.py``'s limits (bf16 and
float32; a check that fails is reported at the end, and the script then
exits non-zero) and times it cold (L2 flushed) and warm, beside the bound, the
plain version, gather + SDPA and an empty kernel launched through the
same ctypes path.  The card's name and power limit come first.  Without
a card it exits non-zero.

``--tree DIR`` times the kernel of another checkout of this repository
(its ``src/``, built into its own ``build/``), on this checkout's
inputs and limits: two versions compared in one call, each in its own
process.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("granite-8b", 32, 8, 128), ("zamba2-2.7b", 32, 32, 80))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="checkout whose kernel is timed (default: this)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_readings: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # the timed tree's package first: chip_smoke (this checkout) then
    # finds repro_torch already imported
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    print(cs.gpu_line(), flush=True)
    print(f"kernel of {args.tree.resolve()}: "
          f"{build.CSRC / 'paged_attention.cu'}")
    build.compile_all(["paged_attention"])
    for name, (regs, st, ld) in sorted(cs.ptxas_report(
            build.build_log.get("paged_attention", {}).get("ptxas", ""))
            .items()):
        print(f"ptxas {name}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B")
    for name, n in sorted(cs.sass_op_counts(
            build.library_path("paged_attention"), "HMMA").items()):
        print(f"SASS {name.split('::')[-1].split('(')[0]}: HMMA {n}")
    dev = torch.device("cuda")
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    if hasattr(kernel, "empty_launch"):
        print(f"empty launch: "
              f"{cs.cuda_ms(lambda: kernel.empty_launch(dev), 50, flush):.4f}"
              f" ms cold, {cs.cuda_ms(lambda: kernel.empty_launch(dev), 50):.4f}"
              f" ms warm")
    failed = []
    for model, H, KV, D in SHAPES:
        for mix, lens in cs.PAGED_MIXES.items():
            inputs = cs.paged_phase_inputs(dev, H, KV, D, lens)
            what = f"{model} {mix}"
            try:
                err = cs.paged_check(inputs, what,
                                     hold_plain_rel_l2=mix == "skewed")
            except AssertionError as e:      # read on, report at the end
                failed.append(str(e))
                err = float("nan")
            ms = cs.cuda_ms(lambda: kernel.paged_attention(*inputs), 50, flush)
            warm_ms = cs.cuda_ms(lambda: kernel.paged_attention(*inputs), 50)
            plain_ms = cs.cuda_ms(lambda: paged_attention_ref(*inputs), 20,
                                  flush)
            library_ms = cs.cuda_ms(cs.paged_library(inputs), 20, flush)
            _, _, bound_ms, _ = cs.paged_bound(inputs)
            print(f"{what} (B={len(lens)}): {ms:.4f} ms cold, {warm_ms:.4f} "
                  f"ms warm; bound {bound_ms:.5f} ms ({bound_ms / ms:.3f} of "
                  f"it); plain {plain_ms:.4f} ms, gather + SDPA "
                  f"{library_ms:.4f} ms; max abs err {err:.3e}", flush=True)
    for e in failed:
        print(f"FAILED: {e}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
