"""Training launcher: data pipeline + model zoo + elastic adaptive runtime.

Port of ``repro.launch.train``.  ``ElasticTrainer`` owns the device
list, the train step, the data pipeline and the shrink/expand protocol
(``core.elastic.ElasticRuntime``), on one device (ROADMAP item 13 for
more).  Each step copies its host batch to the device on the caller's
stream and reads the step's metrics back to the host (one wait a step).

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch granite-8b --reduced --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --reduced --steps 4                                  # on the card
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.checkpointing import make_store
from repro_torch.core.elastic import ElasticRuntime, RescaleEvent
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import adamw


class ElasticTrainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 n_devices: Optional[int] = None, model_par: int = 1,
                 seed: int = 0, store_kind: str = "memory",
                 hp: Optional[adamw.HParams] = None, device="cuda"):
        if model_par != 1:
            raise NotImplementedError(
                f"model_par {model_par}: model parallelism (DeviceMesh / "
                f"DTensor) is ROADMAP item 13")
        self.cfg = cfg
        self.shape = shape
        self.device = resolve_device(device)
        self.data = SyntheticLM(cfg, shape, seed=seed)
        self.step_idx = 0
        self.metrics_log: List[Dict[str, float]] = []
        self.model_par = model_par
        # the reference defaults to every device present; the port runs
        # on one (core.elastic.devices_for)
        n_devices = n_devices or 1
        init = zoo.init_state(cfg, seed, self.device)

        def step_factory(devices):
            return zoo.make_train_step(cfg, hp=hp)

        self.runtime = ElasticRuntime(
            step_factory=step_factory,
            init_state=init,
            n_devices=n_devices,
            store=make_store(store_kind),
            device=self.device,
        )

    # ------------------------------------------------------------- training
    def train(self, n_steps: int, log_every: int = 10) -> Dict[str, float]:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            host = self.data.batch_at(self.step_idx)
            batch = to_device(host, self.runtime.mesh[0])
            metrics = self.runtime.step(batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step"] = self.step_idx
            self.metrics_log.append(metrics)
            if log_every and self.step_idx % log_every == 0:
                print(f"step {self.step_idx:5d} loss {metrics['loss']:.4f} "
                      f"gnorm {metrics['grad_norm']:.3f}", flush=True)
            self.step_idx += 1
        return {"seconds": time.perf_counter() - t0,
                "final_loss": self.metrics_log[-1]["loss"]}

    # ------------------------------------------------------------- elastic
    def rescale(self, n_devices: int) -> RescaleEvent:
        ev = self.runtime.rescale_to(n_devices)
        print(f"[elastic] {ev.kind} {ev.from_devices}->{ev.to_devices} "
              + " ".join(f"{k}={v*1e3:.1f}ms" for k, v in ev.stages.items()),
              flush=True)
        return ev

    @property
    def state(self):
        return self.runtime.state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=sorted(ARCHS))
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False, help="CPU-scale reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n-devices", type=int, default=None)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain versions of "
                         "the kernels")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    shape = SHAPES[args.shape]
    if args.reduced:
        cfg, shape = cfg.reduced(), shape.reduced()
    trainer = ElasticTrainer(cfg, shape, n_devices=args.n_devices,
                             model_par=args.model_par, seed=args.seed,
                             device=args.device)
    out = trainer.train(args.steps)
    print(f"done: {out}")


if __name__ == "__main__":
    main()
