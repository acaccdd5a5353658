"""Training launcher: data pipeline + model zoo + elastic adaptive runtime.

Port of ``repro.launch.train``.  ``ElasticTrainer`` owns the mesh, the
train step, the data pipeline and the shrink/expand protocol
(``core.elastic.ElasticRuntime``).  Without a ``torch.distributed``
process group it trains on one device.  With one (``launch.dist``) it
trains data parallel over the first ``n_devices`` ranks of the world
(``models.model_zoo.DataParallel``: the batch split by rows, the
gradient reduced over the ranks, ZeRO-1 with ``cfg.zero1``), and every
rank of the world builds it and calls ``train`` and ``rescale``: ranks
outside the current mesh skip the steps.  ``model_par`` is the mesh's
model axis, as in the reference's ``_mesh_for``: the mesh is ``(n //
model_par, model_par)``, and over a model axis above 1 every family
trains tensor parallel, moe in every layout of its expert weights, and
moe's batch is routed over the data ranks as the reference routes it
(every dispatch, routing groups and micro-batches that span ranks).  A
rescale gathers the state over both axes
for its checkpoint and places it on the new mesh.  Each step copies its
host batch to the device on the caller's stream and reads the step's
metrics back to the host (one wait a step).

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch granite-8b --reduced --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --n-devices 2 --steps 2     # spawns 2 gloo ranks
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --n-devices 2 --model-par 2 --steps 2   # tensor parallel
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch zamba2-2.7b --reduced --n-devices 2 --model-par 2 --steps 2
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --reduced --n-devices 2 --steps 4     # 2 NCCL ranks on 2 cards
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --reduced --steps 4                                  # on the card
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.checkpointing import make_store
from repro_torch.core.elastic import (ElasticRuntime, RescaleEvent,
                                      distributed)
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.launch import dist as launch_dist
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adamw


class ElasticTrainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 n_devices: Optional[int] = None, model_par: int = 1,
                 seed: int = 0, store_kind: str = "memory",
                 hp: Optional[adamw.HParams] = None, device="cuda"):
        self.cfg = cfg
        self.shape = shape
        self.device = resolve_device(device)
        self.data = SyntheticLM(cfg, shape, seed=seed)
        self.step_idx = 0
        self.metrics_log: List[Dict[str, float]] = []
        self.model_par = model_par
        # as the reference defaults to every device present: every rank
        # of the process group, or the one device without a group
        n_devices = n_devices or (torch.distributed.get_world_size()
                                  if distributed() else 1)
        init = zoo.init_state(cfg, seed, self.device)

        def step_factory(mesh):
            return zoo.make_train_step(
                cfg, hp=hp, mesh=None if isinstance(mesh, list) else mesh)

        self.runtime = ElasticRuntime(
            step_factory=step_factory,
            init_state=init,
            n_devices=n_devices,
            store=make_store(store_kind),
            device=self.device,
            shardings_factory=lambda mesh: zoo.DataParallel(cfg, mesh),
            model_par=model_par,
        )

    # ------------------------------------------------------------- training
    def train(self, n_steps: int, log_every: int = 10) -> Dict[str, float]:
        """``n_steps`` steps; a rank outside the current mesh skips them
        (and logs nothing) but keeps its place in the data stream."""
        t0 = time.perf_counter()
        for _ in range(n_steps):
            if self.runtime.member:
                host = self.data.batch_at(self.step_idx)
                batch = to_device(host, self.runtime.device)
                metrics = self.runtime.step(batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["step"] = self.step_idx
                self.metrics_log.append(metrics)
                if log_every and self.step_idx % log_every == 0:
                    print(f"step {self.step_idx:5d} loss "
                          f"{metrics['loss']:.4f} "
                          f"gnorm {metrics['grad_norm']:.3f}", flush=True)
            self.step_idx += 1
        return {"seconds": time.perf_counter() - t0,
                "final_loss": (self.metrics_log[-1]["loss"]
                               if self.metrics_log else None)}

    # ------------------------------------------------------------- elastic
    def rescale(self, n_devices: int) -> RescaleEvent:
        ev = self.runtime.rescale_to(n_devices)
        if _rank() == 0:
            print(f"[elastic] {ev.kind} {ev.from_devices}->{ev.to_devices} "
                  + " ".join(f"{k}={v*1e3:.1f}ms"
                             for k, v in ev.stages.items()), flush=True)
        return ev

    @property
    def state(self):
        return self.runtime.state


def _rank() -> int:
    return torch.distributed.get_rank() if distributed() else 0


def _train(args):
    """Build the trainer from the command line's flags and train; on a
    rank of a process group, rank 0 alone prints."""
    cfg = ARCHS[args.arch]
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg, shape = cfg.reduced(), shape.reduced()
    trainer = ElasticTrainer(cfg, shape, n_devices=args.n_devices,
                             model_par=args.model_par, seed=args.seed,
                             device=args.device)
    out = trainer.train(args.steps, log_every=10 if _rank() == 0 else 0)
    if _rank() == 0:
        print(f"done: {out}", flush=True)


def _spawned(rank, world, device, args):
    _train(args)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=sorted(ARCHS))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False, help="CPU-scale reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n-devices", type=int, default=None,
                    help="ranks to train on: under torchrun, the first "
                         "n of its world (default all); otherwise n > 1 "
                         "spawns n ranks (nccl on cuda, one card each; "
                         "gloo on cpu)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="the mesh's model axis (tensor parallelism); "
                         "--n-devices counts every rank")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain versions of "
                         "the kernels")
    args = ap.parse_args(argv)

    ranks = launch_dist.torchrun_env()
    if ranks is not None:
        with launch_dist.process_group(*ranks, "env://", args.device):
            _train(args)
    elif (args.n_devices or 1) > 1:
        # by its import name: spawned ranks import the function afresh
        from repro_torch.launch.train import _spawned as fn
        launch_dist.spawn(fn, args.n_devices, args, device=args.device)
    else:
        _train(args)


if __name__ == "__main__":
    main()
