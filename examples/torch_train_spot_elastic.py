"""End-to-end driver on the PyTorch port: train an LM on a simulated spot
fleet with the full adaptive runtime (``examples/train_spot_elastic.py``
on ``repro_torch``): elastic shrink/expand on interruption notices,
proactive capacity rebalancing (Mode C), in-memory checkpointing, and
bit-exact training continuity across rescales.

One rank == one "instance": ``--n-devices`` ranks (8, the device count
the reference forces on its host) are spawned through
``launch.dist.spawn``, and the trainer runs data parallel over them.
Rescales are REAL: state is checkpointed to host memory, the mesh is
rebuilt over the surviving ranks, state is placed anew, and training
resumes on the exact next batch.  Ranks take one card each over NCCL
where there are cards enough; otherwise (one card) they share it over
gloo, as they do on the CPU.

    PYTHONPATH=src python examples/torch_train_spot_elastic.py  # ~22M params
    PYTHONPATH=src python examples/torch_train_spot_elastic.py --full
    PYTHONPATH=src python examples/torch_train_spot_elastic.py --device cpu \\
        --n-devices 4 --steps 6 --seq 32
"""
import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch import dist as launch_dist
from repro_torch.launch.train import ElasticTrainer


def model_cfg(full: bool) -> ModelConfig:
    if full:  # ~110M params (GPT-2-small class)
        return ModelConfig(name="spot-demo-110m", family="dense",
                           num_layers=12, d_model=768, num_heads=12,
                           num_kv_heads=12, d_ff=3072, vocab_size=32768,
                           num_microbatches=2)
    return ModelConfig(name="spot-demo-22m", family="dense",
                       num_layers=6, d_model=384, num_heads=6,
                       num_kv_heads=6, d_ff=1536, vocab_size=16384,
                       num_microbatches=2)


def backend(device: str, n: int) -> str:
    """NCCL with a card a rank; gloo where ranks share a card, and on the
    CPU."""
    if torch.device(device).type == "cuda" and \
            n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank(rank, world, dev, a, out_path):
    """One instance of the fleet: every rank builds the trainer and calls
    ``train`` and ``rescale`` in lockstep; rank 0 prints and writes the
    run's record to ``out_path``."""
    say = print if rank == 0 else (lambda *args, **kw: None)
    cfg = model_cfg(a.full)
    shape = ShapeConfig("train", a.seq, a.batch, "train")
    n = world
    say(f"fleet: {n} instances (ranks); model {cfg.name}")

    trainer = ElasticTrainer(cfg, shape, n_devices=n, device=dev)
    log_every = 5 if rank == 0 else 0

    # --- phase 1: steady state
    trainer.train(a.steps // 3, log_every=log_every)
    loss_before = trainer.metrics_log[-1]["loss"] if rank == 0 else None

    # --- phase 2: two instances get rebalance recommendations -> notices.
    # Mode C (proactive): replacements were requested at the
    # recommendation; a SINGLE rescale swaps the doomed instances for
    # replacements.  The rank count is fixed, so the swap is
    # shrink -> (replacement arrives) -> expand with the expand driven by
    # the capacity-rebalancing trigger; stage timings are real.
    say("\n[cloud] rebalance recommendation on 2 instances "
        "(proactive replacements requested)")
    trainer.rescale(n - 2)       # emergency shrink at the notice
    trainer.train(a.steps // 3, log_every=log_every)
    say("[cloud] replacements ready -> single expand rescale")
    trainer.rescale(n)
    trainer.train(a.steps - 2 * (a.steps // 3), log_every=log_every)

    if rank != 0:
        return
    print("\nrescale stage breakdown (seconds):")
    for ev in trainer.runtime.events:
        print(f"  {ev.kind:7s} {ev.from_devices}->{ev.to_devices}: "
              + ", ".join(f"{k}={v:.3f}" for k, v in ev.stages.items()))
    print(f"\nfinal loss {trainer.metrics_log[-1]['loss']:.4f} "
          f"(pre-interruption {loss_before:.4f}); "
          f"training continued across {len(trainer.runtime.events)} "
          f"rescales", flush=True)
    Path(out_path).write_text(json.dumps({
        "losses": [m["loss"] for m in trainer.metrics_log],
        "steps": [m["step"] for m in trainer.metrics_log],
        "rescales": [(ev.kind, ev.from_devices, ev.to_devices)
                     for ev in trainer.runtime.events]}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="~110M params")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-devices", type=int, default=8,
                    help="ranks (instances) to spawn")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=None,
                    help="wall seconds after which the ranks are killed")
    a = ap.parse_args(argv)
    if a.n_devices < 3:
        raise ValueError("the fleet shrinks by 2 and needs 3 ranks or more")
    resolve_device(a.device)     # no card: raise here, before any rank
    with tempfile.TemporaryDirectory() as tmp:
        out_path = Path(tmp) / "run.json"
        # the rank function by its import name: spawned ranks import it
        # afresh (this file's directory on their path, as on ours)
        here = os.path.dirname(os.path.abspath(__file__))
        if here not in sys.path:
            sys.path.insert(0, here)
        from torch_train_spot_elastic import _rank as fn
        launch_dist.spawn(fn, a.n_devices, a, str(out_path),
                          device=a.device,
                          backend=backend(a.device, a.n_devices),
                          timeout=a.timeout,
                          what="examples/torch_train_spot_elastic.py")
        return json.loads(out_path.read_text())


if __name__ == "__main__":
    main()
