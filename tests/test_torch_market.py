"""The spot-market layer on the port, and against the reference.

A mirror of ``test_market.py`` on ``repro_torch.market`` (the cluster
cases on the port's reduced granite-8b, ``device="cpu"``) and of
``test_faults.py``'s market-driven schedule.  Then parity: both packages
run the same numpy, so a seeded ``SpotMarket`` gives the reference's
prices, dollars and interruption draws exactly, a ``SpotExchange`` the
same purchases, and a seeded market cluster (SimEngine for every mode
and fallback; float32 dense and paged granite-8b) the same journal
digest, summary (market and ledger keys included, wall-clock keys left
out) and streams.
"""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.cluster import InstanceType, ServingCluster
from repro_torch.configs import get_config
from repro_torch.market import (AUTO, FALLBACKS, ON_DEMAND,
                                DifferentMarketFallback,
                                DifferentTypeFallback, MarketAwareScaling,
                                MarketCatalog, OnDemandFallback,
                                PurchaseOrder, QueueWorkFallback,
                                SavingsLedger, ScaleDownFallback,
                                SpotExchange, SpotMarket, make_fallback)
from repro_torch.models import model_zoo as zoo
from repro_torch.runtime import FaultTrace
from repro_torch.serving.workload import synthetic_requests
from tests._torch_parity import JAX, TORCH, f32_models, record

torch.set_num_threads(1)

STD = InstanceType("std.1x", 1.0, cost_per_hour=1.0)
FAST = InstanceType("fast.2x", 2.0, cost_per_hour=1.6)
OD_ONLY = InstanceType("ondemand.1x", 1.0, spot=False, cost_per_hour=1.0)


def two_market_catalog(itypes=(STD,), *, spike=(120.0, 240.0, 5.0),
                       market=TORCH.market):
    """The reference tests' two markets, built by ``market``'s classes
    (the port's by default)."""
    cat = market.MarketCatalog()
    cat.add_market(market.SpotMarket(
        "volatile", base_rate=0.25, volatility=0.06, spikes=(spike,),
        interruptions_per_hour=2.0, price_power=3.0, seed=1,
        horizon=600.0))
    cat.add_market(market.SpotMarket(
        "steady", base_rate=0.45, volatility=0.02,
        interruptions_per_hour=0.05, seed=2, horizon=600.0))
    for it in itypes:
        cat.list_instance(it, markets=("volatile", "steady"))
    return cat


# ------------------------------------------------------------ spot market
def test_price_path_is_seeded_and_floored():
    kw = dict(base_rate=0.3, volatility=0.5, reversion=0.1,
              floor_frac=0.25, horizon=1000.0, dt=5.0)
    a, b = SpotMarket("a", seed=4, **kw), SpotMarket("a", seed=4, **kw)
    ts = np.linspace(0.0, 1200.0, 97)      # incl. beyond the horizon
    assert [a.rate(t) for t in ts] == [b.rate(t) for t in ts]
    assert min(a.rate(t) for t in ts) >= 0.25 * 0.3 - 1e-12
    c = SpotMarket("a", seed=5, **kw)
    assert [a.rate(t) for t in ts] != [c.rate(t) for t in ts]


def test_spike_multiplies_rate_and_couples_intensity():
    m = SpotMarket("m", base_rate=0.2, volatility=0.0,
                   spikes=((100.0, 200.0, 4.0),),
                   interruptions_per_hour=1.5, price_power=2.0)
    assert m.rate(50.0) == pytest.approx(0.2)
    assert m.rate(150.0) == pytest.approx(0.8)
    # intensity scales as (rate/base)**power: 4x price -> 16x intensity
    assert m.intensity(50.0) == pytest.approx(1.5)
    assert m.intensity(150.0) == pytest.approx(1.5 * 16.0)


def test_dollars_matches_numerical_integral():
    m = SpotMarket("m", base_rate=0.3, volatility=0.2, seed=9,
                   spikes=((40.0, 90.0, 3.0),), horizon=400.0, dt=10.0)
    ts = np.linspace(7.0, 311.0, 40_001)
    numeric = np.trapezoid([m.rate(t) for t in ts], ts) / 3600.0
    assert m.dollars(7.0, 311.0) == pytest.approx(numeric, rel=1e-3)
    assert m.mean_rate(7.0, 304.0) \
        == pytest.approx(m.dollars(7.0, 311.0) * 3600.0 / 304.0)


def test_interruption_sampling_is_seeded_and_price_coupled():
    quiet = SpotMarket("q", base_rate=0.3, volatility=0.0,
                       interruptions_per_hour=0.5, horizon=3600.0)
    spiky = SpotMarket("s", base_rate=0.3, volatility=0.0,
                       spikes=((0.0, 3600.0, 5.0),), price_power=3.0,
                       interruptions_per_hour=0.5, horizon=3600.0)
    draws = lambda m, seed: m.sample_interruption(       # noqa: E731
        0.0, np.random.default_rng(seed))
    assert draws(quiet, 3) == draws(quiet, 3)          # seeded
    hits = lambda m: sum(draws(m, s) is not None       # noqa: E731
                         for s in range(40))
    assert hits(spiky) > hits(quiet)                   # 125x intensity
    none_market = SpotMarket("z", base_rate=0.3,
                             interruptions_per_hour=0.0)
    assert draws(none_market, 0) is None
    # the `until` cap bounds the sampled window
    capped = spiky.sample_interruption(0.0, np.random.default_rng(1),
                                       until=10.0)
    assert capped is None or capped <= 10.0


# ---------------------------------------------------------------- catalog
def test_catalog_rejects_bad_registrations():
    cat = MarketCatalog()
    cat.add_market(SpotMarket("m", base_rate=0.3))
    with pytest.raises(ValueError, match="already registered"):
        cat.add_market(SpotMarket("m", base_rate=0.4))
    with pytest.raises(ValueError, match="reserved"):
        cat.add_market(SpotMarket(ON_DEMAND, base_rate=0.4))
    with pytest.raises(KeyError, match="unknown market"):
        cat.list_instance(STD, markets=("nope",))
    cat.list_instance(STD, markets=("m",))
    assert cat.on_demand_rate(STD) == STD.cost_per_hour
    assert cat.markets_for(STD) == ("m",)
    with pytest.raises(KeyError, match="not listed"):
        cat.listing(FAST)


# --------------------------------------------------------------- exchange
def test_adjusted_shopper_walks_away_from_the_spike():
    cat = two_market_catalog()
    naive = SpotExchange(cat, seed=0, mode="naive")
    adjusted = SpotExchange(cat, seed=0, mode="adjusted", lookahead_s=600.0)
    # right now volatile is cheapest; inside the lookahead the spike
    # raises both its mean rate and its interruption intensity
    assert naive.best_market(STD, 110.0) == "volatile"
    assert adjusted.best_market(STD, 110.0) == "steady"
    assert adjusted.effective_price(STD, "volatile", 110.0) \
        > adjusted.effective_price(STD, "steady", 110.0)
    assert adjusted.effective_price(STD, ON_DEMAND, 110.0) \
        == STD.cost_per_hour


def test_purchase_sequence_is_deterministic():
    def interruptions(seed):
        ex = SpotExchange(two_market_catalog(), seed=seed, mode="naive")
        out = []
        for rid in range(5):
            _, t_int = ex.purchase(rid, STD, t=5.0 * rid, market="volatile")
            out.append(t_int)
        return out

    assert interruptions(7) == interruptions(7)
    assert interruptions(7) != interruptions(8)


def test_non_spot_instance_always_buys_on_demand():
    cat = two_market_catalog((STD, OD_ONLY))
    ex = SpotExchange(cat, seed=0, mode="naive")
    rec, t_int = ex.purchase(0, OD_ONLY, t=0.0, market=AUTO)
    assert rec.market == ON_DEMAND and t_int is None
    rec, t_int = ex.purchase(1, STD, t=0.0, market=ON_DEMAND)
    assert rec.market == ON_DEMAND and t_int is None


def test_overhead_estimate_learns_from_drain_records():
    ex = SpotExchange(two_market_catalog(), default_overhead_s=60.0)
    assert ex.estimated_overhead_s() == 60.0
    ex.bind_metrics(SimpleNamespace(drains=[
        SimpleNamespace(checkpoint_s=2.0, restore_s=1.0),
        SimpleNamespace(checkpoint_s=4.0, restore_s=3.0)]))
    assert ex.estimated_overhead_s() == pytest.approx(65.0)
    assert ex.interruption_dollars(STD, overhead_s=3600.0) \
        == pytest.approx(STD.cost_per_hour)


# -------------------------------------------------------------- fallbacks
def _rep(itype=STD, market="volatile"):
    return SimpleNamespace(rid=0, itype=itype, model_id=itype.model_id,
                           purchase=SimpleNamespace(market=market))


def test_fallback_strategies():
    cat = two_market_catalog((STD, FAST))
    ex = SpotExchange(cat, seed=0, mode="adjusted")
    rep, view, now = _rep(), None, 110.0
    assert OnDemandFallback().replacement(view, rep, ex, now) \
        == PurchaseOrder(STD, ON_DEMAND)
    # different_market excludes the doomed market, keeps the hardware
    order = DifferentMarketFallback().replacement(view, rep, ex, now)
    assert order.itype == STD and order.market == "steady"
    # different_type reshops the hardware too
    order = DifferentTypeFallback().replacement(view, rep, ex, now)
    assert order.itype == FAST
    assert QueueWorkFallback().replacement(view, rep, ex, now) is None
    assert QueueWorkFallback().queue_until_free
    assert ScaleDownFallback().replacement(view, rep, ex, now) is None
    assert not ScaleDownFallback().queue_until_free


def test_make_fallback():
    assert make_fallback("queue_work").name == "queue_work"
    fb = OnDemandFallback()
    assert make_fallback(fb) is fb
    assert make_fallback(None) is None
    assert set(FALLBACKS) == {"on_demand", "different_market",
                              "different_type", "queue_work", "scale_down"}
    with pytest.raises(ValueError, match="unknown fallback"):
        make_fallback("nope")


# ----------------------------------------------------------------- ledger
def test_ledger_savings_and_breakdowns():
    cat = two_market_catalog()
    SavingsLedger(cat)
    ex = SpotExchange(cat, seed=0, mode="naive")
    # a cheap pre-spike spot holding vs the same period on demand
    ex.purchase(0, STD, t=0.0, market="volatile")
    ex.ledger.on_terminate(0, 100.0)
    ex.purchase(1, STD, t=0.0, market=ON_DEMAND, strategy="scale_up")
    spot_cost = cat.market("volatile").dollars(0.0, 100.0)
    od_cost = STD.cost_per_hour * 100.0 / 3600.0
    rep = ex.ledger.report(100.0)
    assert rep["market_dollar_cost"] \
        == pytest.approx(spot_cost + od_cost, abs=1e-6)
    assert rep["on_demand_dollar_cost"] == pytest.approx(2 * od_cost,
                                                         abs=1e-6)
    assert rep["savings_pct"] == pytest.approx(
        100.0 * (1.0 - (spot_cost + od_cost) / (2 * od_cost)), abs=1e-3)
    assert rep["market_volatile_purchases"] == 1
    assert rep["market_on_demand_purchases"] == 1
    assert rep["market_steady_purchases"] == 0     # zero-filled
    assert rep["strategy_initial_purchases"] == 1
    assert rep["strategy_scale_up_purchases"] == 1
    ex.ledger.on_interruption(0, 50.0, overhead_s=2.5)
    assert ex.ledger.report(100.0)["spot_interruptions"] == 1
    assert ex.ledger.report(100.0)["spot_interruption_overhead_s"] \
        == pytest.approx(2.5)


# ---------------------------------------------------------------- scaling
def test_market_aware_scaling_shops_effective_price():
    cat = two_market_catalog((STD, FAST))
    ex = SpotExchange(cat, seed=0, mode="adjusted")
    pol = MarketAwareScaling(ex)
    view = SimpleNamespace(log=lambda msg: None, now=110.0)
    # FAST: 2.0 speed at 1.6 od; on steady both cost ~the same market
    # rate, so speed/$ picks the faster hardware
    pick = pol.select_itype(view, STD.model_id, [])
    assert pick == FAST
    assert pol.replacement(view, _rep()) == FAST


# ----------------------------------------------------------- end to end
@pytest.fixture(scope="module")
def model():
    cfg = get_config("granite-8b").reduced()
    params = zoo.init_serving_params(cfg, seed=0, device="cpu")
    return cfg, params


def _market_cluster(model, *, mode="adjusted",
                    fallback="different_market",
                    spike=(5.0, 300.0, 6.0)):
    cfg, params = model
    fleet = [STD, STD]
    cat = two_market_catalog(spike=spike)
    ex = SpotExchange(cat, seed=0, mode=mode, sample_until=400.0)
    cl = ServingCluster(cfg, params, fleet, dt=1.0, batch_size=2,
                        max_seq=32, rebalance_lead=4.0,
                        notice_deadline=3.0, market=ex, fallback=fallback,
                        autoscaler_kw=dict(replacement_latency=6.0,
                                           scale_down_idle=10_000.0),
                        device="cpu")
    for r in synthetic_requests(10, cfg.vocab_size, seed=0,
                                prompt_len=(3, 8)):
        cl.submit(r, at=0.0)
    return cl


def _market_run(model, **kw):
    cl = _market_cluster(model, **kw)
    return cl, cl.run(max_time=5000)


def test_cluster_market_run_reports_savings(model):
    cl, out = _market_run(model, mode="naive")
    assert out["dropped"] == 0
    assert 0.0 < out["market_dollar_cost"] < out["on_demand_dollar_cost"]
    assert out["savings_pct"] == pytest.approx(
        100.0 * (1.0 - out["market_dollar_cost"]
                 / out["on_demand_dollar_cost"]), abs=1e-2)
    for key in ("market_volatile_purchases", "market_steady_purchases",
                "strategy_initial_purchases", "spot_interruptions"):
        assert key in out, key
    # the naive shopper bought into the spiking market and got burned;
    # the fallback bought replacement capacity mid-run
    assert out["spot_interruptions"] > 0
    assert out["strategy_different_market_purchases"] > 0
    assert any("buy r" in msg for _, msg in cl.timeline)


def test_cluster_market_run_is_deterministic(model):
    (cl_a, out_a), (cl_b, out_b) = (_market_run(model, mode="naive")
                                    for _ in range(2))
    # staging overheads are REAL wall-clock store timings; everything
    # else (prices, interruption times, dollars) is bit-identical
    wall = ("interruption_overhead_s", "preempt_stage_s",
            "spot_interruption_overhead_s")
    assert {k: v for k, v in out_a.items() if k not in wall} \
        == {k: v for k, v in out_b.items() if k not in wall}
    assert cl_a.timeline == cl_b.timeline
    assert cl_a.faults.interruptions == cl_b.faults.interruptions


def test_interrupted_units_carry_their_hop_journal(model, monkeypatch):
    """A market-driven interruption drain stamps each displaced unit's
    journey (interruption -> land) onto its shared hop journal, visible
    end-to-end under a stable uid."""
    cl = _market_cluster(model, mode="naive")
    captured = []
    orig = cl.readmit
    monkeypatch.setattr(
        cl, "readmit",
        lambda units, now: (captured.extend(units), orig(units, now))[1])
    out = cl.run(max_time=5000)
    assert out["spot_interruptions"] > 0 and captured
    journeys = {u.uid: [h.reason for h in u.hops] for u in captured}
    assert any(j and j[0] == "interruption" and "land" in j
               for j in journeys.values()), journeys
    migrated = [tr for tr in cl.metrics.traces.values()
                if tr.migrations > 0]
    assert migrated, "no request was migrated by the interruption drain"


def test_queue_work_fallback_parks_until_capacity(model):
    """queue_work buys NO replacement: displaced units park until a
    surviving replica has a free slot.  An on-demand instance in the
    fleet guarantees a survivor, so nothing is dropped."""
    cfg, params = model
    cat = two_market_catalog((STD, OD_ONLY), spike=(5.0, 300.0, 6.0))
    ex = SpotExchange(cat, seed=0, mode="naive", sample_until=400.0)
    cl = ServingCluster(cfg, params, [STD, OD_ONLY], dt=1.0,
                        batch_size=2, max_seq=32, rebalance_lead=4.0,
                        notice_deadline=3.0, market=ex,
                        fallback="queue_work",
                        autoscaler_kw=dict(scale_down_idle=10_000.0),
                        device="cpu")
    for r in synthetic_requests(10, cfg.vocab_size, seed=0,
                                prompt_len=(3, 8)):
        cl.submit(r, at=0.0)
    out = cl.run(max_time=5000)
    assert out["dropped"] == 0 and out["spot_interruptions"] > 0
    # queue_work buys nothing: every purchase is an initial buy
    assert out["purchases"] == out["strategy_initial_purchases"] == 2


def test_market_requires_fallback_pairing(model):
    cfg, params = model
    with pytest.raises(ValueError, match="market"):
        ServingCluster(cfg, params, [STD], fallback="on_demand",
                       device="cpu")


def test_market_driven_schedule_is_purchase_deterministic():
    """Same exchange seed + same purchase sequence -> bit-identical
    interruption schedule in the trace (whole-cluster determinism)."""

    def build():
        cat = MarketCatalog()
        cat.add_market(SpotMarket("m", base_rate=0.3,
                                  interruptions_per_hour=30.0, seed=5))
        it = InstanceType("std.1x", 1.0, cost_per_hour=1.0)
        cat.list_instance(it, markets=("m",))
        ex = SpotExchange(cat, seed=7, mode="naive")
        trace = FaultTrace(rebalance_lead=6.0, notice_deadline=4.0)
        for rid in range(6):
            _, t_int = ex.purchase(rid, it, t=10.0 * rid, market="m")
            if t_int is not None:
                trace.inject(t_int, rid)
        return trace

    a, b = build(), build()
    assert a.interruptions and a.interruptions == b.interruptions
    assert np.all([x == y for x, y in zip(a.interruptions,
                                          b.interruptions)])


# ------------------------------------------------- parity with repro
def _market_view(p, seed):
    """Every number a seeded market gives, read the same way in either
    package: rates and intensities on a grid (spike edges and past the
    horizon included), dollars and means over windows, and interruption
    draws from seeded generators (with and without ``until``)."""
    m = p.market.SpotMarket(
        "m", base_rate=0.3, volatility=0.2, reversion=0.15, seed=seed,
        spikes=((40.0, 90.0, 3.0), (200.0, 260.0, 1.5)),
        interruptions_per_hour=6.0, price_power=2.5, horizon=600.0,
        dt=7.0)
    ts = np.linspace(0.0, 700.0, 141)
    spans = [(0.0, 600.0), (7.0, 311.0), (40.0, 90.0), (255.5, 980.0)]
    return dict(
        rate=[m.rate(t) for t in ts],
        intensity=[m.intensity(t) for t in ts],
        dollars=[m.dollars(a, b) for a, b in spans],
        mean_rate=[m.mean_rate(a, b - a) for a, b in spans],
        mean_intensity=[m.mean_intensity(a, b - a) for a, b in spans],
        draws=[m.sample_interruption(t0, np.random.default_rng((seed, k)),
                                     until=until)
               for k, (t0, until) in enumerate(
                   [(0.0, None), (30.0, None), (100.0, 400.0),
                    (250.0, 260.0), (590.0, None)] * 4)])


@pytest.mark.parametrize("seed", range(5))
def test_spot_market_matches_reference(seed):
    ref, got = _market_view(JAX, seed), _market_view(TORCH, seed)
    assert any(t is not None for t in got["draws"])
    assert got == ref


def _purchases(p, mode):
    """A purchase sequence through ``AUTO`` shopping over three types
    (one never spot), across the spike: every record, the interruption
    draw of each, and the ledger's report."""
    C, M = p.cluster, p.market
    std = C.InstanceType("std.1x", 1.0, cost_per_hour=1.0)
    fast = C.InstanceType("fast.2x", 2.0, cost_per_hour=1.6)
    od = C.InstanceType("ondemand.1x", 1.0, spot=False, cost_per_hour=1.0)
    ex = M.SpotExchange(two_market_catalog((std, fast, od), market=M),
                        seed=3, mode=mode, sample_until=500.0)
    out = []
    for rid, (it, t) in enumerate([(std, 0.0), (fast, 30.0), (od, 60.0),
                                   (std, 110.0), (fast, 150.0),
                                   (std, 250.0), (std, 400.0)]):
        rec, t_int = ex.purchase(rid, it, t=t, market=M.AUTO,
                                 strategy="initial" if t == 0 else "x")
        out.append((dataclasses.asdict(rec), t_int))
        if rid % 2:
            ex.ledger.on_terminate(rid, t + 45.0)
    offer = ex.best_offer("default", 110.0)
    return dict(purchases=out, report=ex.ledger.report(600.0),
                offer=(offer[0].name, offer[1]))


@pytest.mark.parametrize("mode", ["naive", "adjusted"])
def test_exchange_purchases_match_reference(mode):
    ref, got = _purchases(JAX, mode), _purchases(TORCH, mode)
    assert {rec["market"] for rec, _ in got["purchases"]} >= {"on_demand"}
    assert got == ref


def _sim_market_run(p, mode, fallback):
    """A SimEngine fleet of two spot ``std.1x`` and one on-demand replica
    bought on the two-market exchange (the spike from t = 5), serving a
    Poisson interactive/batch mix through the markets' spot notices and
    one injected at t = 20 on r1, so that every mode's fallback acts."""
    C, M, W = p.cluster, p.market, p.workload
    std = C.InstanceType("std.1x", 1.0, cost_per_hour=1.0)
    fast = C.InstanceType("fast.2x", 2.0, cost_per_hour=1.6)
    od = C.InstanceType("ondemand.1x", 1.0, spot=False, cost_per_hour=1.0)
    cat = two_market_catalog((std, fast, od), spike=(5.0, 300.0, 6.0),
                             market=M)
    ex = M.SpotExchange(cat, seed=0, mode=mode, sample_until=400.0)
    trace = p.runtime.FaultTrace(rebalance_lead=4.0, notice_deadline=3.0)
    trace.inject(20.0, 1)
    cl = C.ServingCluster(
        None, None, [std, std, od], engine="sim", trace=trace,
        router=C.DeadlineAwareRouter(), batch_size=4, max_seq=256,
        dt=1.0, admission="priority", market=ex, fallback=fallback,
        autoscaler_kw=dict(replacement_latency=6.0,
                           scale_down_idle=10_000.0), **p.dev)
    reqs = W.classed_requests(40, 1000, interactive_frac=0.5, seed=3)
    cl.attach_arrivals(W.PoissonArrivals(reqs, 0.5, seed=1))
    return record(cl, reqs, cl.run(max_time=10_000))


@pytest.mark.parametrize("fallback", sorted(FALLBACKS))
@pytest.mark.parametrize("mode", ["naive", "adjusted"])
def test_sim_market_cluster_matches_reference(mode, fallback):
    ref = _sim_market_run(JAX, mode, fallback)
    got = _sim_market_run(TORCH, mode, fallback)
    s = got["summary"]
    assert s["completed"] == 40 and s["dropped"] == 0
    assert s["purchases"] >= 3 and "market_volatile_dollars" in s
    assert s["drains"] >= 1
    if mode == "naive":
        assert s["spot_interruptions"] > 0
    assert got == ref


@pytest.fixture(scope="module")
def f32():
    return f32_models()


def _engine_market_run(p, model, mode, paged):
    """The reference's ``_market_cluster`` (two ``std.1x`` replicas on the
    spiking exchange, ``different_market`` fallback, 10 requests at t =
    0) on real engines, dense or paged."""
    cfg, params = model
    C, M = p.cluster, p.market
    std = C.InstanceType("std.1x", 1.0, cost_per_hour=1.0)
    ex = M.SpotExchange(two_market_catalog((std,), spike=(5.0, 300.0, 6.0),
                                           market=M),
                        seed=0, mode=mode, sample_until=400.0)
    engine = None
    if paged:
        engine = functools.partial(p.engine.ServingEngine,
                                   cache_mode="paged", block_size=8)
    cl = C.ServingCluster(cfg, params, [std, std], dt=1.0, batch_size=2,
                          max_seq=32, rebalance_lead=4.0,
                          notice_deadline=3.0, market=ex,
                          fallback="different_market", engine=engine,
                          autoscaler_kw=dict(replacement_latency=6.0,
                                             scale_down_idle=10_000.0),
                          **p.dev)
    reqs = p.workload.synthetic_requests(10, cfg.vocab_size, seed=0,
                                         prompt_len=(3, 8))
    for r in reqs:
        cl.submit(r, at=0.0)
    return record(cl, reqs, cl.run(max_time=5000))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("mode", ["naive", "adjusted"])
def test_market_cluster_matches_reference_f32(f32, mode, paged):
    ref = _engine_market_run(JAX, f32["jax"], mode, paged)
    got = _engine_market_run(TORCH, f32["torch"], mode, paged)
    s = got["summary"]
    assert s["completed"] == 10 and s["dropped"] == 0
    if mode == "naive":
        assert s["spot_interruptions"] > 0 and s["drains"] > 0
    assert got == ref
