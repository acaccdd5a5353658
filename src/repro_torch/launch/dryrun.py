"""Dry run: every (arch x shape) cell traced, its cost counted, no device.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell with ``jax.jit`` over a production mesh of forced host devices and
reads XLA's cost and memory analysis.  The port runs each cell's function
once on meta tensors (shapes and dtypes, no storage) under
``hlo_analysis.CostCounter``, which counts the FLOPs, bytes,
collectives, kernel calls and live memory of what it dispatches.  The
functions, the CLI, the record keys and the extrapolation are the
reference's; ``compile_s`` holds the trace's seconds, and
``raw_terms_body_once`` a whole run's terms (an eager run has no loop
body counted once).

**Device-free by design**, as the reference's dry run is: it allocates
no memory on any device, computes nothing on the CPU, and writes the
same records on a machine with a card.  It is not a CPU fallback of
anything.

Over a mesh of more than one rank the process is rank 0 of a ``"fake"``
process group of ``prod(mesh shape)`` ranks (``fake_world``: no other
process, no network; its collectives return at once and are counted),
and the cell runs the port's own per-rank program on rank 0's blocks:
``make_train_step(cfg, mesh=mesh)`` on ``DataParallel.place``'s state,
``make_prefill`` / ``make_serve_step(cfg, shape, mesh=mesh)`` on
``serving_params``' parameters and ``ServingMesh.place_state``'s decode
state (the reference's KV cache layout; the recurrent state of the
rank's SSM heads).  A (1, 1) mesh needs no process group.

Covered: every kind at a (1, 1) mesh, and on the single-pod (16, 16)
and the multi-pod (2, 16, 16) mesh every cell: ``train_4k``, and
``prefill_32k`` and ``decode_32k`` of every family, with ``long_500k``
for ssm and hybrid.  Over the multi-pod mesh (rank 0 of a fake group of
512) the batch and the decode state's rows go over the 32 pod x data
ranks (``launch.sharding.batch_group``) and ZeRO-1 over the 16 data
ranks alone, as the reference's rules give them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.roofline
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import ShardingRules, axis_sizes
from repro_torch.launch.specs import cell_fn, input_specs
from repro_torch.models import model_zoo as zoo

ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "artifacts"
                / "dryrun_torch")
PRODUCTION_MESHES = {"single": ((16, 16), ("data", "model")),
                     "multi": ((2, 16, 16), ("pod", "data", "model"))}


# --------------------------------------------------------------- meshes
@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a ``"fake"`` process group of ``world``
    ranks (``torch.testing``'s ``FakeStore``), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def production_mesh(kind: str):
    """The production mesh ``kind`` ("single" or "multi") for the life of
    the block: a ``DeviceMesh`` whose rank 0 this process is, in a fake
    group opened here."""
    shape, axes = PRODUCTION_MESHES[kind]
    with fake_world(math.prod(shape)):
        yield make_mesh(shape, axes, device="cpu")


# --------------------------------------------------------------- tracing
def trace_cell(cfg, shape, mesh):
    """One run of the cell's function on meta tensors under a
    ``CostCounter``: ``(counter, seconds)``.  Over a mesh of more than
    one rank, rank 0's program (the caller holds the process group the
    mesh was made in)."""
    n = math.prod(axis_sizes(mesh).values())
    args = input_specs(cfg, shape, ShardingRules(mesh))["args"]
    if n == 1:
        fn = cell_fn(cfg, shape)
    else:
        fn = cell_fn(cfg, shape, mesh)
        if shape.kind == "train":
            args = (zoo.DataParallel(cfg, mesh).place(args[0]), args[1])
        else:
            params = zoo.abstract_serving_params(cfg, mesh)
            args = ((params, args[1]) if shape.kind == "prefill" else
                    (params, zoo.ServingMesh(cfg, shape, mesh).place_state(
                        args[1]), args[2]))
    counter = H.CostCounter()
    t0 = time.perf_counter()
    counter.run(fn, *args)
    return counter, time.perf_counter() - t0


def production_record(cfg, shape, mesh):
    counter, dt = trace_cell(cfg, shape, mesh)
    return {
        "compile_s": round(dt, 2),
        "memory": H.memory_stats(counter),
        # a whole run's terms: an eager run counts every layer
        "raw_terms_body_once": H.extract_terms(counter),
        "n_devices": math.prod(axis_sizes(mesh).values()),
    }


def _analysis_cfg(cfg, n_units, n_micro):
    """Shrink the stack to ``n_units`` layer-units."""
    kw = dict(attn_impl="full", num_microbatches=n_micro)
    if cfg.family == "enc_dec":
        kw.update(enc_layers=n_units, dec_layers=n_units, num_layers=0)
    elif cfg.family == "hybrid":
        kw.update(num_layers=cfg.attn_every * n_units)
    else:
        kw.update(num_layers=n_units)
    return cfg.with_(**kw)


def production_units(cfg) -> int:
    if cfg.family == "enc_dec":
        return cfg.enc_layers
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def analysis_points(cfg, shape, mesh):
    """Small traces for linear cost extrapolation.

    train: cost(L, M) = a + M*b + M*L*d  -> 3 points
    other: cost(L)    = a + L*d          -> 2 points
    """
    pts = []
    if shape.kind == "train":
        per_micro = shape.global_batch // max(cfg.num_microbatches, 1)
        for (L_, M_) in [(1, 1), (2, 1), (1, 2)]:
            shape_a = ShapeConfig(shape.name, shape.seq_len,
                                  per_micro * M_, shape.kind)
            counter, dt = trace_cell(_analysis_cfg(cfg, L_, M_), shape_a,
                                     mesh)
            terms = H.extract_terms(counter)
            terms.update(L=L_, M=M_, compile_s=round(dt, 2))
            pts.append(terms)
    else:
        for L_ in (1, 2):
            counter, dt = trace_cell(
                _analysis_cfg(cfg, L_, cfg.num_microbatches), shape, mesh)
            terms = H.extract_terms(counter)
            terms.update(L=L_, M=1, compile_s=round(dt, 2))
            pts.append(terms)
    return pts


# --------------------------------------------------------------- the CLI
def run_cell(arch: str, shape_name: str, *, meshes=("single", "multi"),
             analysis=True, out_dir: Path = ARTIFACT_DIR,
             force=False, opts=()) -> dict:
    """Trace one cell (``opts`` as the reference's; ``donate`` is a no-op
    in an eager run) and write its record to ``out_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())

    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    if "zero1" in opts:
        cfg = cfg.with_(zero1=True)
    if "overlapped" in opts:
        cfg = cfg.with_(grad_schedule="overlapped")
    if "bf16params" in opts:
        cfg = cfg.with_(param_dtype="bfloat16")
    for o in opts:
        if o.startswith("micro="):
            cfg = cfg.with_(num_microbatches=int(o.split("=")[1]))
        if o.startswith("moe="):
            cfg = cfg.with_(moe_impl=o.split("=")[1])
    if "gradbf16" in opts:
        cfg = cfg.with_(grad_reduce_dtype="bfloat16")
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["skipped"] = why
        path.write_text(json.dumps(rec, indent=1))
        return rec

    try:
        for mesh_kind in meshes:
            with production_mesh(mesh_kind) as mesh:
                rec[f"production_{mesh_kind}"] = production_record(
                    cfg, shape, mesh)
        if analysis:
            with production_mesh("single") as mesh:
                rec["analysis_points"] = analysis_points(cfg, shape, mesh)
            rec["production_L_units"] = production_units(cfg)
            rec["production_M"] = (cfg.num_microbatches
                                   if shape.kind == "train" else 1)
        rec["ok"] = True
    except Exception as e:  # a dry-run failure is a bug in our system
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--no-analysis", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--opt", default="",
                    help="comma list: zero1,overlapped,donate,bf16params,"
                         "micro=N")
    args = ap.parse_args()

    meshes = {"both": ("single", "multi"), "single": ("single",),
              "multi": ("multi",)}[args.mesh]
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)

    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            t0 = time.time()
            rec = run_cell(arch, shape_name, meshes=meshes,
                           analysis=not args.no_analysis,
                           out_dir=Path(args.out), force=args.force,
                           opts=tuple(o for o in args.opt.split(",") if o))
            status = ("SKIP " + rec["skipped"] if "skipped" in rec
                      else "OK" if rec.get("ok") else
                      "FAIL " + rec.get("error", "?"))
            print(f"[{time.time()-t0:7.1f}s] {arch:22s} {shape_name:12s} "
                  f"{status}", flush=True)
            if not rec.get("ok") and "skipped" not in rec:
                n_fail += 1
    print(f"done; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
