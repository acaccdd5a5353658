"""Roofline table from dry-run records.

Port of ``repro.launch.roofline``.  Reads ``artifacts/dryrun_torch/
*.json`` (``launch.dryrun``; a record in the reference's schema reads the
same: the keys are the reference's), extrapolates the analysis points to
the production (layers, microbatches), and emits per-cell roofline
terms with the H100 SXM's data-sheet constants (``hlo_analysis``):

  t_compute    = flops_per_device / 989e12
  t_memory     = hbm_bytes_per_device / 3.35e12
  t_collective = wire_bytes_per_device / 450e9

plus MODEL_FLOPS (6*N*D train / 2*N*D inference, active-params for MoE), the
useful-compute ratio, the dominant term, and per-device memory from the
full-depth production trace.  These are computed from counts and
constants, not measured.

``--traced`` reads instead the terms of each record's full-depth
production trace on ``--mesh`` (``production_single``, rank 0 of 256,
or ``production_multi``, the multi-pod (2, 16, 16) mesh's rank 0 of
512): the port's eager trace counts every layer, so they are taken as
they are, with no extrapolation, and a prefill's attention is the path
it runs (blockwise past 8192 positions) where the analysis points trace
full attention.  The multi-pod mesh has no analysis points (they are
the single-pod mesh's), so ``--mesh multi`` implies ``--traced``.

Cost model (exact for homogeneous stacks):
  train:  c(L, M) = a + M*b + M*L*d   (3 analysis points)
  other:  c(L)    = a + L*d           (2 analysis points)
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.dryrun import ARTIFACT_DIR
from repro_torch.launch.hlo_analysis import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.models import model_zoo as zoo

CHIPS_SINGLE_POD = 256
CHIPS = {"single": CHIPS_SINGLE_POD, "multi": 2 * CHIPS_SINGLE_POD}


def _metric(pt: dict, key: str) -> float:
    return float(pt.get(key, 0.0))


def extrapolate(points: List[dict], key: str, kind: str, L: int,
                M: int) -> float:
    """Linear cost-model fit -> value at production (L, M)."""
    if kind == "train":
        by = {(p["L"], p["M"]): _metric(p, key) for p in points}
        c11, c21, c12 = by[(1, 1)], by[(2, 1)], by[(1, 2)]
        d = c21 - c11                 # per-layer per-microbatch
        b = c12 - 2 * c11 + d        # c12 = a + 2b + 2d; c11 = a + b + d
        a = c11 - b - d
        return max(a + M * b + M * L * d, 0.0)
    by = {p["L"]: _metric(p, key) for p in points}
    d = by[2] - by[1]
    a = by[1] - d
    return max(a + L * d, 0.0)


def model_flops(arch: str, shape_name: str) -> float:
    shape = SHAPES[shape_name]
    n = zoo.active_params(ARCHS[arch])
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
        return (6.0 if shape.kind == "train" else 2.0) * n * tokens
    return 2.0 * n * shape.global_batch  # one new token per sequence


def cell_roofline(rec: dict, mesh: str = "single",
                  traced: bool = False) -> Optional[dict]:
    """One cell's terms on the ``mesh`` production mesh: extrapolated
    from the analysis points, or (``traced``; always for the multi-pod
    mesh) read from the full-depth production trace on it; ``None``
    without them."""
    traced = traced or mesh != "single"
    if "analysis_points" not in rec or traced and \
            f"production_{mesh}" not in rec:
        return None
    kind = rec["kind"]
    if not traced:
        L = rec["production_L_units"]
        M = rec.get("production_M", 1)
        pts = rec["analysis_points"]
        flops = extrapolate(pts, "flops", kind, L, M)
        hbm = extrapolate(pts, "bytes_accessed", kind, L, M)
        wire = extrapolate(pts, "wire_bytes", kind, L, M)
    else:
        terms = rec[f"production_{mesh}"]["raw_terms_body_once"]
        flops, hbm, wire = (_metric(terms, k) for k in
                            ("flops", "bytes_accessed", "wire_bytes"))
    t_c = flops / PEAK_FLOPS
    t_m = hbm / HBM_BW
    t_w = wire / LINK_BW
    dominant = max(
        (("compute", t_c), ("memory", t_m), ("collective", t_w)),
        key=lambda kv: kv[1])[0]
    mf = model_flops(rec["arch"], rec["shape"])
    useful = mf / (flops * CHIPS[mesh]) if flops else 0.0
    mem = rec.get(f"production_{mesh}", {}).get("memory", {})
    bound = max(t_c, t_m, t_w)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "kind": kind,
        "flops_per_device": flops, "hbm_bytes_per_device": hbm,
        "wire_bytes_per_device": wire,
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_w,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": useful,
        "roofline_fraction": (t_c / bound) if bound else 0.0,
        "peak_hbm_gib": mem.get("peak_hbm_estimate", 0) / 2**30,
    }


def load_table(art_dir: Path = ARTIFACT_DIR, mesh: str = "single",
               traced: bool = False) -> List[dict]:
    rows = []
    for f in sorted(Path(art_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if "skipped" in rec:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "skipped": rec["skipped"]})
            continue
        if not rec.get("ok"):
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "error": rec.get("error")})
            continue
        r = cell_roofline(rec, mesh, traced)
        if r:
            rows.append(r)
    return rows


def fmt_seconds(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def markdown_table(rows: List[dict]) -> str:
    hdr = ("| arch | shape | t_compute | t_memory | t_collective | dominant "
           "| useful | roofline-frac | HBM GiB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"SKIP | — | — | — |\n")
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | |\n")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_seconds(r['t_compute_s'])}"
            f" | {fmt_seconds(r['t_memory_s'])} "
            f"| {fmt_seconds(r['t_collective_s'])} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} "
            f"| {r['peak_hbm_gib']:.1f} |\n")
    return "".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default=str(ARTIFACT_DIR))
    ap.add_argument("--json", default=None, help="dump rows as json")
    ap.add_argument("--mesh", default="single", choices=sorted(CHIPS),
                    help="the production mesh whose terms to tabulate")
    ap.add_argument("--traced", action="store_true",
                    help="the full-depth production trace's terms, not "
                         "the analysis points' extrapolation")
    args = ap.parse_args()
    rows = load_table(Path(args.art), args.mesh, args.traced)
    print(markdown_table(rows))
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
