"""LULESH proxy — compute-bound unstructured-hydro stand-in (paper §III-B).

Same tile/halo structure as Jacobi2D but each step runs several rounds of
stencil + EOS-like transcendental work, so compute dominates communication
(the property that makes LULESH the paper's contrast case to Jacobi2D).
Driven through the same overdecomposed runtime, in plain torch ops (the
reference has no Pallas kernel for it); see apps/jacobi2d.py.
"""
from repro_torch.apps.jacobi2d import JacobiRun, run_jacobi


def run_lulesh(**kw) -> JacobiRun:
    kw.setdefault("kernel", "lulesh")
    return run_jacobi(**kw)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    out = run_lulesh(grid_size=512, n_pes=4, odf=4, iters=12,
                     device=a.device)
    print(f"time/iter = {out.time_per_iter*1e3:.2f} ms")
