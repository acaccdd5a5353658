"""The purchase window: price quotes, market shopping, and buys.

:class:`SpotExchange` is the single place replicas are bought.  It
quotes two kinds of price per (instance type, market):

* ``naive`` — the spot rate *right now*; the cheapest-now shopper.
* ``adjusted`` — the interruption-adjusted effective price over a
  lookahead window:

      mean_rate(t, W) + mean_intensity(t, W) * interruption_dollars

  where ``interruption_dollars`` prices one interruption as the
  on-demand rate times the estimated overhead (drain checkpoint +
  restore + re-prefill seconds, measured from ``ClusterMetrics`` drain
  records once any exist).  Because a market's scheduled price spikes
  raise both its mean rate and its intensity inside the window, the
  adjusted shopper walks away from a pool that is about to get
  expensive *and* flaky — the A/B the ``cluster_spot_market``
  benchmark measures.

Every ``purchase()`` draws the instance's interruption time from an
RNG seeded by ``(exchange seed, purchase index)``: the same purchase
sequence under the same seed yields a bit-identical interruption
schedule, which keeps whole-cluster runs deterministic.

Port of ``repro.market.exchange``.  ``estimated_overhead_s`` adds the
drains' measured (wall-clock) stage seconds to the prior, as the
reference does.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Optional, Tuple

import numpy as np

from repro_torch.cluster.replica import InstanceType
from repro_torch.market.catalog import MarketCatalog, ON_DEMAND
from repro_torch.market.ledger import PurchaseRecord, SavingsLedger

#: ``purchase(market=AUTO)``: shop every listed market for the type.
AUTO = "auto"

MODES = ("naive", "adjusted")


class SpotExchange:
    def __init__(self, catalog: MarketCatalog, *, seed: int = 0,
                 mode: str = "adjusted", lookahead_s: float = 600.0,
                 default_overhead_s: float = 60.0,
                 sample_until: Optional[float] = None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; pick from {MODES}")
        self.catalog = catalog
        self.seed = seed
        self.mode = mode
        self.lookahead_s = lookahead_s
        self.default_overhead_s = default_overhead_s
        self.sample_until = sample_until   # cap on interruption sampling
        self.ledger = SavingsLedger(catalog)
        self._idx = itertools.count()
        self._metrics = None               # ClusterMetrics, once attached

    # ----------------------------------------------------------- wiring
    def bind_metrics(self, metrics):
        """Let overhead estimates learn from observed drain records."""
        self._metrics = metrics

    def estimated_overhead_s(self) -> float:
        """Seconds of work one interruption costs: measured drain
        checkpoint+restore overhead when records exist (plus the
        re-prefill/migration prior), the prior alone otherwise."""
        measured = 0.0
        drains = getattr(self._metrics, "drains", None)
        if drains:
            measured = sum(d.checkpoint_s + d.restore_s
                           for d in drains) / len(drains)
        return self.default_overhead_s + measured

    # ---------------------------------------------------------- pricing
    def spot_rate(self, market: str, t: float) -> float:
        return self.catalog.market(market).rate(t)

    def interruption_dollars(self, itype: InstanceType,
                             overhead_s: Optional[float] = None) -> float:
        """Dollar cost of one interruption: the overhead seconds repriced
        at the hardware's no-risk (on-demand) rate."""
        oh = self.estimated_overhead_s() if overhead_s is None else overhead_s
        return self.catalog.on_demand_rate(itype) * oh / 3600.0

    def effective_price(self, itype: InstanceType, market: str, t: float,
                        *, overhead_s: Optional[float] = None) -> float:
        """$/hour used for shopping: mode-dependent (see module doc)."""
        if market == ON_DEMAND:
            return self.catalog.on_demand_rate(itype)
        m = self.catalog.market(market)
        if self.mode == "naive":
            return m.rate(t)
        return (m.mean_rate(t, self.lookahead_s)
                + m.mean_intensity(t, self.lookahead_s)
                * self.interruption_dollars(itype, overhead_s))

    # --------------------------------------------------------- shopping
    def best_market(self, itype: InstanceType, t: float, *,
                    exclude: Iterable[str] = (),
                    include_on_demand: bool = False) -> Optional[str]:
        """Cheapest market (by the mode's price) for ``itype`` at ``t``."""
        skip = set(exclude)
        names = [m for m in self.catalog.markets_for(itype) if m not in skip]
        if include_on_demand and ON_DEMAND not in skip:
            names.append(ON_DEMAND)
        if not names:
            return None
        return min(names, key=lambda m: (self.effective_price(itype, m, t),
                                         m))

    def best_offer(self, model_id: str, t: float, *,
                   exclude_itype: Optional[InstanceType] = None
                   ) -> Optional[Tuple[InstanceType, str]]:
        """Best (itype, market) across the catalog for ``model_id``:
        maximal speed per effective dollar, on-demand included as the
        no-risk candidate."""
        best, best_key = None, None
        for it in self.catalog.itypes(model_id):
            if exclude_itype is not None and it.name == exclude_itype.name:
                continue
            market = self.best_market(it, t, include_on_demand=True)
            if market is None:
                continue
            price = self.effective_price(it, market, t)
            key = (-it.speed / max(price, 1e-9), price, it.name)
            if best_key is None or key < best_key:
                best, best_key = (it, market), key
        return best

    # ------------------------------------------------------------- buys
    def purchase(self, rid: int, itype: InstanceType, *, t: float,
                 market: str = AUTO, strategy: str = "initial"
                 ) -> Tuple[PurchaseRecord, Optional[float]]:
        """Buy one ``itype`` for replica ``rid`` at time ``t``.

        Returns ``(record, interruption_t)``; ``interruption_t`` is
        ``None`` for on-demand buys and for spot buys whose sampled
        interruption falls beyond the market horizon.
        """
        if not itype.spot:
            market = ON_DEMAND     # hardware flagged non-spot never risks
        elif market == AUTO:
            market = self.best_market(itype, t) or ON_DEMAND
        idx = next(self._idx)
        t_int = None
        if market == ON_DEMAND:
            rate = self.catalog.on_demand_rate(itype)
        else:
            m = self.catalog.market(market)
            rate = m.rate(t)
            rng = np.random.default_rng((self.seed, idx))
            t_int = m.sample_interruption(t, rng, until=self.sample_until)
        rec = PurchaseRecord(
            rid=rid, itype=itype.name, model_id=itype.model_id,
            market=market, strategy=strategy, t_buy=float(t),
            on_demand_rate=self.catalog.on_demand_rate(itype),
            rate_at_buy=rate)
        self.ledger.on_purchase(rec)
        return rec, t_int
