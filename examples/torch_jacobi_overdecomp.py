"""Paper Fig 2-3 mini on the PyTorch port: overdecomposition + rate-aware
LB on Jacobi2D (``examples/jacobi_overdecomp.py`` on ``repro_torch``;
the Jacobi tile steps run the port's CUDA kernel on the card).

Sweeps the overdecomposition factor under an injected cloud-like network
latency, then shows rate-aware GreedyRefine on a heterogeneous "fleet".

    PYTHONPATH=src python examples/torch_jacobi_overdecomp.py     # the card
    PYTHONPATH=src python examples/torch_jacobi_overdecomp.py --device cpu
"""
import argparse

from repro_torch.apps.jacobi2d import run_jacobi


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lb-grid", type=int, default=1024,
                    help="grid side of the load-balancing runs")
    a = ap.parse_args(argv)

    lines = []

    def say(line):
        print(line)
        lines.append(line)

    print("== overdecomposition under 200us/msg latency (4 PEs) ==")
    for odf in (1, 2, 4, 8):
        out = run_jacobi(grid_size=512, n_pes=4, odf=odf, iters=12,
                         comm_latency_s=200e-6, device=a.device)
        say(f"  odf={odf}: {out.time_per_iter*1e3:7.2f} ms/iter")

    print("== rate-aware LB on heterogeneous PEs (c7i/c6a/c5a-like rates) ==")
    print("   (LULESH proxy: compute-bound, as in paper Fig 3b)")
    rates = [1.0, 0.85, 0.6, 1.0]
    for strat, aware in ((None, False), ("greedy_refine", False),
                         ("greedy_refine", True)):
        out = run_jacobi(grid_size=a.lb_grid, n_pes=4, odf=4, iters=24,
                         kernel="lulesh", pe_rate_multipliers=rates,
                         lb_strategy=strat, lb_every=8, rate_aware=aware,
                         device=a.device)
        tail = out.per_iter[-8:]
        tpi = sum(m["time_per_iter"] for m in tail) / len(tail)
        label = "no LB" if strat is None else \
            ("GreedyRefine rate-aware" if aware else "GreedyRefine rate-blind")
        say(f"  {label:26s}: {tpi*1e3:7.2f} ms/iter (steady state)")
    return lines


if __name__ == "__main__":
    main()
