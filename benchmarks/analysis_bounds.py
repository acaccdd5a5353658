#!/usr/bin/env python3
"""The cost analysis at the cells PERF.md §2 bounds by hand; no card.

    PYTHONPATH=src python benchmarks/analysis_bounds.py

Traces one cell function of each on meta tensors at a (1, 1) mesh
(``launch.dryrun.trace_cell``: device-free, nothing computed) and prints
its counted FLOPs, bytes and kernel calls and the roofline terms at the
H100 SXM's data-sheet constants (``launch.hlo_analysis``) beside the
hand-computed bound:

* one decode step at 8 lanes of 1024 positions for the four paged main
  paths (granite-8b, mamba2-780m, zamba2-2.7b, qwen2-moe-a2.7b), the
  dense ``serve_step`` of ``launch.specs.cell_fn``: every layer reads
  its lanes' whole dense cache, where the hand bound reads each weight
  once plus the lanes' filled KV rows or state;
* granite-8b's 16384-token prefill (one sequence; attention through the
  flash kernel past 8192 tokens, counted by its ``cost``), whose floor
  is the GEMMs at the bf16 peak and flash at its bound.

The terms are computed from counts and constants, not measured.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402

ONE = MeshShape.of((1, 1), ("data", "model"))
DECODE = ShapeConfig("decode_8x1024", 1024, 8, "decode")
PREFILL = ShapeConfig("prefill_16k", 16384, 1, "prefill")
# (arch, shape, PERF.md §2's hand-computed bound in ms)
CELLS = (("granite-8b", DECODE, 5.115), ("mamba2-780m", DECODE, 0.831),
         ("zamba2-2.7b", DECODE, 1.860), ("qwen2-moe-a2.7b", DECODE, 8.798),
         ("granite-8b", PREFILL, 340.0))


def main() -> int:
    print("| arch | cell | FLOPs | bytes | kernel calls | t_compute ms | "
          "t_memory ms | hand bound ms | max(t) / bound |")
    print("|---|---|---|---|---|---|---|---|---|")
    for arch, shape, bound_ms in CELLS:
        counter, _ = dryrun.trace_cell(get_config(arch), shape, ONE)
        t = H.RooflineTerms(counter.flops, counter.bytes, 0.0)
        calls = {k: v["calls"] for k, v in counter.kernels.items()}
        worst = max(t.t_compute, t.t_memory) * 1e3
        print(f"| {arch} | {shape.name} | {counter.flops} | {counter.bytes}"
              f" | {calls or '-'} | {t.t_compute * 1e3:.3f} | "
              f"{t.t_memory * 1e3:.3f} | {bound_ms} | "
              f"{worst / bound_ms:.2f} |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
