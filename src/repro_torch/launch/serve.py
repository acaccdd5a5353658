"""Serving launcher: one continuous-batching engine, or a cluster of them,
over an --arch of the dense (granite-8b, llama3.2-3b, ...), moe
(qwen2-moe-a2.7b, qwen3-moe-30b-a3b), ssm (mamba2-780m) or hybrid
(zamba2-2.7b) family.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --no-reduced --cache-mode paged --batch-size 8 --max-seq 1024
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen2-moe-a2.7b --no-reduced --cache-mode paged \
      --batch-size 8 --max-seq 1024

On the CPU, at the reduced size:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch mamba2-780m --requests 4 --max-new 4 --cache-mode paged

Cluster mode — replicated engines on a heterogeneous spot fleet, with
rate-aware routing and a drained interruption (``--cache-mode paged``
builds every replica with a paged cache):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --cluster --fleet 2x2.0,2x0.7 --router rate_aware --requests 24 \
      --interrupt-at 4

Chaos drill — seeded fault soup (hard kills, slowdowns, contention,
endpoint failures) survived via checkpoints + heartbeat detection:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --cluster --fleet 2x1.0 --requests 10 --chaos 3 --chaos-rate 0.05 \
      --checkpoint-every 3

Spot-market mode — replicas bought on two priced markets, a fallback
on each spot notice, and the savings against all on-demand:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --cluster --fleet 2x2.0,2x0.7 --market adjusted \
      --fallback different_market --scaling cost_aware --slo-mix 0.5 \
      --router slo_aware --requests 12

Vertical elasticity — in-place resize with QoS-classed capacity:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --cluster --vertical window --qos --slo-mix 0.5 --requests 12

Port of ``repro.launch.serve``.
"""

from __future__ import annotations

import argparse
import functools
import time

from repro_torch.configs import ARCHS
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import ServingEngine


def _make_requests(args, cfg):
    from repro_torch.serving.workload import (classed_requests,
                                              synthetic_requests)
    if getattr(args, "slo_mix", None) is not None:
        return classed_requests(args.requests, cfg.vocab_size,
                                interactive_frac=args.slo_mix,
                                seed=args.seed)
    return synthetic_requests(
        args.requests, cfg.vocab_size, seed=args.seed,
        prompt_len=(3, min(12, args.max_seq // 2)), max_new=args.max_new)


def _parse_fleet(spec: str):
    """'2x2.0,2x0.7@0.5' -> two speed-2.0 replicas at the default $1/h +
    two speed-0.7 replicas at $0.50/h (cost feeds the dollar metrics and
    cost-aware scaling)."""
    from repro_torch.cluster import InstanceType
    fleet = []
    try:
        for part in spec.split(","):
            count, speed = part.split("x")
            speed, _, cost = speed.partition("@")
            for _ in range(int(count)):
                fleet.append(InstanceType(
                    f"spot.{speed}x", float(speed),
                    cost_per_hour=float(cost) if cost else 1.0))
    except ValueError:
        raise SystemExit(
            f"bad --fleet spec {spec!r}: expected "
            f"'<count>x<speed>[@<cost_per_hour>],...' like '2x2.0,2x0.7@0.5'")
    if not fleet:
        raise SystemExit("--fleet spec produced an empty fleet")
    return fleet


def run_single(args, cfg, params):
    engine = ServingEngine(cfg, params, batch_size=args.batch_size,
                           max_seq=args.max_seq,
                           temperature=args.temperature, seed=args.seed,
                           prefill_mode=args.prefill_mode,
                           decode_block=args.decode_block,
                           cache_mode=args.cache_mode, device=args.device)
    reqs = _make_requests(args, cfg)
    for req in reqs:
        engine.submit(req)
    stats = engine.run_until_idle()
    done = sum(r.done for r in reqs)
    print(f"arch={cfg.name} cache={args.cache_mode} device={engine.device} "
          f"served {done}/{len(reqs)} requests, "
          f"{stats['tokens']} tokens in {stats['seconds']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s) host_syncs={engine.host_syncs}")


def _make_exchange(args, fleet):
    """Default two-market exchange over the fleet's instance types: a
    cheap-but-volatile market (scheduled price spike, spike-coupled
    interruption intensity) and a pricier steady one, both priced
    relative to the fleet's mean on-demand rate."""
    from repro_torch.market import MarketCatalog, SpotExchange, SpotMarket
    itypes = sorted({it for it in fleet}, key=lambda it: it.name)
    od = sum(it.cost_per_hour for it in itypes) / len(itypes)
    cat = MarketCatalog()
    cat.add_market(SpotMarket(
        "volatile", base_rate=0.25 * od, volatility=0.08,
        spikes=((120.0, 360.0, 5.0),), interruptions_per_hour=2.0,
        price_power=3.0, seed=args.seed + 1))
    cat.add_market(SpotMarket(
        "steady", base_rate=0.45 * od, volatility=0.02,
        interruptions_per_hour=0.1, seed=args.seed + 2))
    for it in itypes:
        cat.list_instance(it, markets=("volatile", "steady"))
    return SpotExchange(cat, seed=args.seed, mode=args.market)


def run_cluster(args, cfg, params):
    """Serve ``args.requests`` over the ``args.fleet`` cluster and print
    the reference's report; returns ``(cluster, requests, summary)``."""
    from repro_torch.cluster import (CheckpointPolicy, FailureDetector,
                                     PREEMPTION_POLICIES, ROUTERS,
                                     SCALING_POLICIES, ServingCluster,
                                     StragglerPolicy)
    from repro_torch.runtime import FaultTrace
    from repro_torch.serving.workload import make_arrivals
    fleet = _parse_fleet(args.fleet)
    preemption = PREEMPTION_POLICIES[args.preemption]() \
        if args.preemption != "none" else None
    exchange = None
    if args.market != "off":
        exchange = _make_exchange(args, fleet)
    # --chaos SEED samples a mixed fault soup (hard kills, slowdowns,
    # network contention, endpoint failures) and arms recovery: periodic
    # checkpoints (--checkpoint-every), heartbeat failure detection, and
    # straggler quarantine
    trace = checkpoint = health = straggler = None
    if args.chaos is not None:
        trace = FaultTrace.chaos_sampled(
            rate=args.chaos_rate, horizon=200.0, targets=len(fleet),
            seed=args.chaos, rebalance_lead=args.rebalance_lead,
            notice_deadline=args.notice_deadline)
        health = FailureDetector()
        straggler = StragglerPolicy()
    if args.checkpoint_every is not None:
        checkpoint = CheckpointPolicy(interval=args.checkpoint_every)
    elif args.chaos is not None:
        checkpoint = CheckpointPolicy()
    # --vertical arms an in-place resize recommender; --qos layers the
    # Guaranteed/Burstable/BestEffort capacity contract on admission and
    # shrink-eviction order (either works alone, they compose when both
    # are set)
    qos = vertical = None
    if args.qos or args.vertical != "off":
        from repro_torch.vertical import QoSPolicy, VERTICAL_POLICIES
        if args.qos:
            qos = QoSPolicy()
        if args.vertical != "off":
            vertical = VERTICAL_POLICIES[args.vertical](qos=qos)
    scaling = None
    if args.scaling == "cost_aware":
        if exchange is not None:
            # market mode: shop (instance type, market) pairs by speed
            # per interruption-adjusted effective dollar
            from repro_torch.market import MarketAwareScaling
            scaling = MarketAwareScaling(exchange)
        else:
            # the catalog is the distinct instance types in the fleet
            catalog = sorted({it for it in fleet}, key=lambda it: it.name)
            scaling = SCALING_POLICIES["cost_aware"](catalog)
    engine = None
    if args.cache_mode != "dense":
        engine = functools.partial(ServingEngine, cache_mode=args.cache_mode)
    cl = ServingCluster(cfg, params, fleet,
                        router=ROUTERS[args.router](),
                        batch_size=args.batch_size, max_seq=args.max_seq,
                        temperature=args.temperature,
                        prefill_mode=args.prefill_mode,
                        decode_block=args.decode_block,
                        dt=1.0, seed=args.seed,
                        rebalance_lead=args.rebalance_lead,
                        notice_deadline=args.notice_deadline,
                        admission=args.admission,
                        rebalance_interval=args.migrate_every,
                        preemption=preemption, scaling=scaling,
                        market=exchange,
                        fallback=args.fallback if exchange else None,
                        trace=trace, checkpoint=checkpoint,
                        health=health, straggler=straggler,
                        vertical=vertical, qos=qos,
                        engine=engine, device=args.device)
    reqs = _make_requests(args, cfg)
    cl.attach_arrivals(make_arrivals(args.arrival, reqs, seed=args.seed))
    if args.interrupt_at is not None:
        cl.inject_interruption(t=args.interrupt_at, replica_rid=0)
    t0 = time.perf_counter()
    out = cl.run()
    wall = time.perf_counter() - t0
    print(f"arch={cfg.name} router={args.router} fleet={args.fleet} "
          f"cache={args.cache_mode} device={cl.device}")
    print(f"  completed {out['completed']}/{out['submitted']} "
          f"(dropped {out['dropped']}), {out['total_tokens']} tokens")
    print(f"  virtual: makespan={out['virtual_seconds']:.0f}s "
          f"p50={out['p50_latency']:.1f}s p99={out['p99_latency']:.1f}s "
          f"agg={out['tok_per_s']:.2f} tok/s  (wall {wall:.1f}s)")
    if out["drains"]:
        print(f"  drains={out['drains']} migrated_slots="
              f"{out['migrated_slots']} ckpt+restore="
              f"{out['interruption_overhead_s']*1e3:.1f}ms")
    if out["rebalance_migrations"]:
        print(f"  rebalance_migrations={out['rebalance_migrations']}")
    if out["preemptions"]:
        print(f"  preemptions={out['preemptions']} "
              f"resumes={out['resumes']}")
    if out["vertical_grows"] or out["vertical_shrinks"]:
        print(f"  vertical: grows={out['vertical_grows']} "
              f"shrinks={out['vertical_shrinks']} "
              f"evictions={out['vertical_evictions']} "
              f"stage={out['resize_stage_s']*1e3:.1f}ms")
    if args.qos:
        print(f"  qos slot-s: guaranteed="
              f"{out['qos_guaranteed_slot_s']:.1f} "
              f"burstable={out['qos_burstable_slot_s']:.1f} "
              f"best_effort={out['qos_best_effort_slot_s']:.1f}")
    if out["hard_kills"] or out["checkpoints"]:
        print(f"  chaos: hard_kills={out['hard_kills']} "
              f"lost={out['requests_lost']} "
              f"recovered={out['requests_recovered']} "
              f"replayed_tokens={out['replayed_tokens']} "
              f"checkpoints={out['checkpoints']} "
              f"quarantines={out['quarantines']}")
    if out["slowdowns"] or out["contention_windows"] \
            or out["endpoint_faults"]:
        print(f"  degraded: slowdowns={out['slowdowns']} "
              f"contention_windows={out['contention_windows']} "
              f"(+{out['contention_delay_s']:.1f}s staging) "
              f"endpoint_faults={out['endpoint_faults']} "
              f"retries={out['endpoint_retries']}")
    print(f"  fleet_dollar_cost=${out['fleet_dollar_cost']:.4f}")
    if exchange is not None:
        print(f"  market[{args.market}]: "
              f"cost=${out['market_dollar_cost']:.4f} "
              f"vs on-demand ${out['on_demand_dollar_cost']:.4f} "
              f"-> savings {out['savings_pct']:.1f}% "
              f"({out['spot_interruptions']} interruptions, "
              f"fallback={args.fallback})")
        for m in exchange.catalog.markets():
            n = out.get(f"market_{m.name}_purchases", 0)
            if n:
                print(f"    {m.name}: {n} buys "
                      f"${out[f'market_{m.name}_dollars']:.4f} "
                      f"{out[f'market_{m.name}_interruptions']} "
                      f"interruptions")
    for k in sorted(out):
        if k.startswith("attainment_"):
            slo = k[len("attainment_"):]
            print(f"  slo[{slo}]: attainment={out[k]:.3f} "
                  f"p99={out.get(f'p99_latency_{slo}', 0.0):.1f}s "
                  f"misses={out.get(f'misses_{slo}', 0)}")
    for rs in cl.metrics.per_replica():
        print(f"  replica r{rs['rid']} {rs['itype']}: {rs['tokens']} tok "
              f"@ {rs['tok_per_s']:.2f} tok/s (measured)")
    for t, msg in cl.timeline:
        print(f"  [{t:7.1f}s] {msg}")
    return cl, reqs, out


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
    # cluster mode
    ap.add_argument("--cluster", action="store_true",
                    help="serve over a replicated heterogeneous fleet")
    ap.add_argument("--fleet", default="2x2.0,2x0.7",
                    help="fleet spec: '<count>x<speed>,...'")
    ap.add_argument("--router", default="rate_aware",
                    choices=("rate_aware", "round_robin", "slo_aware"))
    ap.add_argument("--admission", default="fifo",
                    choices=("fifo", "priority"),
                    help="priority holds batch-class arrivals until the "
                         "fleet has backlog headroom")
    ap.add_argument("--preemption", default="none",
                    choices=("none", "slo"),
                    help="slo pauses batch-class slots (WorkUnit "
                         "preempt/resume) when waiting interactive work "
                         "would miss its deadline")
    ap.add_argument("--scaling", default="backlog",
                    choices=("backlog", "cost_aware"),
                    help="cost_aware shops the fleet's instance types by "
                         "speed per dollar on every scale-up/replacement")
    ap.add_argument("--vertical", default="off",
                    choices=("off", "fixed", "window"),
                    help="in-place replica resize: fixed reacts to "
                         "instantaneous backlog per lane, window to a "
                         "sliding-window mean (no drain; evicted slots "
                         "park and resume)")
    ap.add_argument("--qos", action="store_true",
                    help="QoS-classed capacity: interactive=Guaranteed "
                         "(reserved), standard=Burstable, batch="
                         "BestEffort (bursts into idle capacity, "
                         "evicted first on shrink)")
    ap.add_argument("--slo-mix", type=float, default=None,
                    help="serve an interactive/batch SLO mix with this "
                         "interactive fraction (default: class-less)")
    ap.add_argument("--migrate-every", type=float, default=None,
                    help="mid-stream migration pass interval in virtual "
                         "seconds (default: off)")
    ap.add_argument("--market", default="off",
                    choices=("off", "naive", "adjusted"),
                    help="buy replicas on priced spot markets; naive "
                         "shops the cheapest rate right now, adjusted "
                         "the interruption-adjusted effective price")
    ap.add_argument("--fallback", default="on_demand",
                    choices=("on_demand", "different_market",
                             "different_type", "queue_work",
                             "scale_down"),
                    help="replacement strategy on a spot rebalance "
                         "recommendation (market mode only)")
    ap.add_argument("--interrupt-at", type=float, default=None,
                    help="inject a spot interruption on replica 0 at this "
                         "virtual time")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="sample a seeded chaos soup (hard kills, "
                         "slowdowns, network contention, endpoint "
                         "failures) and arm heartbeat failure detection "
                         "+ straggler quarantine + checkpoints")
    ap.add_argument("--chaos-rate", type=float, default=0.02,
                    help="chaos fault arrivals per virtual second "
                         "(with --chaos)")
    ap.add_argument("--checkpoint-every", type=float, default=None,
                    metavar="S",
                    help="periodic WorkUnit recovery checkpoints every S "
                         "virtual seconds (default: on with --chaos at "
                         "the policy's interval, else off)")
    ap.add_argument("--rebalance-lead", type=float, default=6.0)
    ap.add_argument("--notice-deadline", type=float, default=4.0)
    ap.add_argument("--arrival", default="batch",
                    help="offered load: batch | poisson:<rate> | "
                         "trace:<file>")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    params = zoo.init_serving_params(cfg, seed=args.seed, device=args.device)
    if args.cluster:
        return run_cluster(args, cfg, params)
    run_single(args, cfg, params)


if __name__ == "__main__":
    main()
