"""Serving launcher: one continuous-batching engine over an --arch of the
dense (granite-8b, llama3.2-3b, ...), ssm (mamba2-780m) or hybrid
(zamba2-2.7b) family.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --no-reduced --cache-mode paged --batch-size 8 --max-seq 1024

On the CPU, at the reduced size:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch mamba2-780m --requests 4 --max-new 4 --cache-mode paged

Port of ``repro.launch.serve``'s single-engine mode.  The cluster mode
comes with the layers above the engine (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.workload import synthetic_requests


def run_single(args, cfg, params):
    engine = ServingEngine(cfg, params, batch_size=args.batch_size,
                           max_seq=args.max_seq,
                           temperature=args.temperature, seed=args.seed,
                           prefill_mode=args.prefill_mode,
                           decode_block=args.decode_block,
                           cache_mode=args.cache_mode, device=args.device)
    reqs = synthetic_requests(
        args.requests, cfg.vocab_size, seed=args.seed,
        prompt_len=(3, min(12, args.max_seq // 2)), max_new=args.max_new)
    for req in reqs:
        engine.submit(req)
    stats = engine.run_until_idle()
    done = sum(r.done for r in reqs)
    print(f"arch={cfg.name} cache={args.cache_mode} device={engine.device} "
          f"served {done}/{len(reqs)} requests, "
          f"{stats['tokens']} tokens in {stats['seconds']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s) host_syncs={engine.host_syncs}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced CPU-scale config (--no-reduced for "
                         "the published width and depth)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain versions of "
                         "the kernels")
    ap.add_argument("--cache-mode", default="dense",
                    choices=("dense", "paged"))
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-mode", default="chunked",
                    choices=("chunked", "streamed"),
                    help="chunked bulk prefill or the streamed per-token "
                         "baseline")
    ap.add_argument("--decode-block", type=int, default=8,
                    help="fused decode steps per window (sync-free)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    params = zoo.init_serving_params(cfg, seed=args.seed, device=args.device)
    run_single(args, cfg, params)


if __name__ == "__main__":
    main()
