"""Quickstart on the PyTorch port: train a small LM with the adaptive
runtime (``examples/quickstart.py`` on ``repro_torch``).

The trainer spans every device present, as the reference's spans
``jax.devices()``: the cards on ``cuda`` (one card: one device), one
device on the CPU.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.train import ElasticTrainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    cfg = get_config("llama3.2-3b").reduced()     # small same-family config
    shape = SHAPES["train_4k"].reduced()
    n = torch.cuda.device_count() if torch.device(a.device).type == "cuda" \
        else 1
    trainer = ElasticTrainer(cfg, shape, n_devices=n, device=a.device)
    out = trainer.train(n_steps=20, log_every=5)
    print(f"\ntrained 20 steps in {out['seconds']:.1f}s; "
          f"final loss {out['final_loss']:.4f}")
    assert out["final_loss"] < 6.5, "loss should be at/below ln(vocab)"
    return out


if __name__ == "__main__":
    main()
