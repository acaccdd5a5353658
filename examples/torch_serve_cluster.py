"""Serving-cluster example on the PyTorch port: the paper's runtime ideas
on a serving fleet (``examples/serve_cluster.py`` on ``repro_torch``).

A heterogeneous fleet (two 2.0x replicas, two 0.7x replicas) serves one
batch of requests under each router of ``ROUTERS`` (rate-oblivious
round-robin, rate-aware GreedyRefine on *measured* tokens/sec, ...), and
a spot interruption hits a fast replica mid-run every time.  The doomed
replica is drained: its in-flight slots are checkpointed through the
in-memory store and re-admitted on survivors, so zero requests (and zero
decoded tokens) are lost.

    PYTHONPATH=src python examples/torch_serve_cluster.py         # the card
    PYTHONPATH=src python examples/torch_serve_cluster.py --device cpu
"""
import argparse

from repro_torch.cluster import InstanceType, ROUTERS, ServingCluster
from repro_torch.configs import get_config
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.workload import PoissonArrivals, synthetic_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    cfg = get_config("granite-8b").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device=a.device)
    fleet = [InstanceType("fast.2x", 2.0), InstanceType("fast.2x", 2.0),
             InstanceType("slow.1x", 0.7), InstanceType("slow.1x", 0.7)]

    outs = {}
    for name, router_cls in ROUTERS.items():
        cluster = ServingCluster(cfg, params, fleet, router=router_cls(),
                                 dt=1.0, batch_size=2, max_seq=32,
                                 rebalance_lead=6.0, notice_deadline=4.0,
                                 device=a.device)
        # open-loop offered load: 3 req/s Poisson, scheduled one arrival
        # event at a time on the shared runtime loop
        reqs = synthetic_requests(20, cfg.vocab_size, seed=0)
        cluster.attach_arrivals(PoissonArrivals(reqs, 3.0, seed=0))
        cluster.inject_interruption(t=4.0, replica_rid=0)   # FIS analogue
        out = cluster.run()
        print(f"{name:12s} makespan={out['virtual_seconds']:5.0f}s "
              f"p99={out['p99_latency']:5.1f}s "
              f"agg={out['tok_per_s']:.2f} tok/s "
              f"dropped={out['dropped']} migrated={out['migrated_slots']}")
        outs[name] = out
    return outs


if __name__ == "__main__":
    main()
