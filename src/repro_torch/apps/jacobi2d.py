"""Jacobi2D — the paper's benchmark application on the overdecomposed
tile runtime (solves the Laplace equation; hot top edge).

The port of ``repro/apps/jacobi2d.py``: it drives the port's
``HostTileRuntime`` (tiles on the device, one stencil-kernel launch per
PE per step, per-PE device times, heterogeneity and latency injectable).
Runs on the card unless the caller asks for the CPU:

    python -m repro_torch.apps.jacobi2d --grid 16384 --pes 4 --odf 4
    python -m repro_torch.apps.jacobi2d --device cpu --grid 512
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.overdecomp import (CommModel, HostTileRuntime,
                                         TileGrid, choose_tiling)
from repro_torch.device import dtype_of


@dataclasses.dataclass
class JacobiRun:
    time_per_iter: float
    accounted_time_per_iter: float   # jitter-free model time (see overdecomp)
    per_iter: List[Dict[str, float]]
    lb_events: List[dict]


def run_jacobi(*, grid_size: int = 512, n_pes: int = 4, odf: int = 4,
               iters: int = 20, kernel: str = "jacobi",
               comm_latency_s: float = 0.0, comm_bw_Bps: float = float("inf"),
               pe_rate_multipliers: Optional[Sequence[float]] = None,
               lb_strategy: Optional[str] = None, lb_every: int = 10,
               rate_aware: bool = True, warmup: int = 2,
               dtype=torch.float32, device="cuda") -> JacobiRun:
    n_tiles = n_pes * odf
    tr, tc = choose_tiling(n_tiles)
    # grid must divide tiles; round up
    H = ((grid_size + tr - 1) // tr) * tr
    W = ((grid_size + tc - 1) // tc) * tc
    rt = HostTileRuntime(
        TileGrid(H, W, tr, tc), n_pes, kernel=kernel, odf=odf, dtype=dtype,
        pe_rate_multipliers=pe_rate_multipliers,
        comm=CommModel(comm_latency_s, comm_bw_Bps), device=device)
    per_iter = []
    lb_events = []
    for it in range(iters):
        m = rt.step()
        if it >= warmup:
            per_iter.append(m)
        if lb_strategy and (it + 1) % lb_every == 0:
            res = rt.load_balance(lb_strategy, rate_aware=rate_aware)
            lb_events.append({"iter": it, "migrations": res.migrations,
                              "makespan": res.makespan,
                              "baseline": res.baseline_makespan})
    tpi = float(np.mean([m["time_per_iter"] for m in per_iter]))
    acc = float(np.mean([m["accounted_time_per_iter"] for m in per_iter]))
    return JacobiRun(tpi, acc, per_iter, lb_events)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--pes", type=int, default=4)
    ap.add_argument("--odf", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernel", default="jacobi",
                    choices=["jacobi", "lulesh"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    a = ap.parse_args()
    out = run_jacobi(grid_size=a.grid, n_pes=a.pes, odf=a.odf,
                     iters=a.iters, kernel=a.kernel,
                     dtype=dtype_of(a.dtype), device=a.device)
    print(f"time/iter = {out.time_per_iter*1e3:.2f} ms")
