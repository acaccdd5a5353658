"""Serving example on the PyTorch port: continuous-batching decode with
KV-cache slots (``examples/serve.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_serve.py                 # the card
    PYTHONPATH=src python examples/torch_serve.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    cfg = get_config("llama3.2-3b").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device=a.device)
    engine = ServingEngine(cfg, params, batch_size=4, max_seq=64,
                           device=a.device)

    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(6):
        plen = int(rng.integers(3, 9))
        reqs.append(Request(rid=rid,
                            prompt=rng.integers(0, cfg.vocab_size, plen,
                                                dtype=np.int32),
                            max_new_tokens=8))
        engine.submit(reqs[-1])
    stats = engine.run_until_idle()
    print(f"served 6 requests: {stats['tokens']} tokens in "
          f"{stats['seconds']:.2f}s ({stats['tok_per_s']:.1f} tok/s on "
          f"{engine.device})")
    return {"stats": stats, "requests": reqs}


if __name__ == "__main__":
    main()
