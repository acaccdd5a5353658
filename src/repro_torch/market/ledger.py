"""The savings ledger: what the fleet actually paid vs all-on-demand.

Every replica purchase is a :class:`PurchaseRecord` — which market it
was bought in (or on-demand), under which strategy (initial fleet,
scale-up, or a fallback on a spot notice), and when it started/ended.
The ledger bills spot purchases by integrating the market's actual
price path over the holding period and compares against the
counterfactual of holding the same instances on-demand for the same
durations — the savings % the paper's spot-instance extension exists
to harvest.  ``report()`` flattens totals plus by-market and
by-strategy breakdowns into the ``ClusterMetrics.summary()`` dict.

Port of ``repro.market.ledger``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.market.catalog import MarketCatalog, ON_DEMAND


@dataclasses.dataclass
class PurchaseRecord:
    """One replica bought on the exchange."""
    rid: int
    itype: str
    model_id: str
    market: str               # market name, or ON_DEMAND
    strategy: str             # initial | scale_up | <fallback name> | ...
    t_buy: float
    on_demand_rate: float     # counterfactual $/hour for this hardware
    rate_at_buy: float        # price observed at purchase time
    t_end: Optional[float] = None         # retirement time (None = running)
    interrupted_t: Optional[float] = None

    @property
    def spot(self) -> bool:
        return self.market != ON_DEMAND


class SavingsLedger:
    """Actual vs all-on-demand dollars, by market and by strategy."""

    def __init__(self, catalog: MarketCatalog):
        self.catalog = catalog
        self.purchases: List[PurchaseRecord] = []
        self._open: Dict[int, PurchaseRecord] = {}
        self.interruptions = 0
        self.interruption_overhead_s = 0.0

    # ----------------------------------------------------------- events
    def on_purchase(self, rec: PurchaseRecord):
        self.purchases.append(rec)
        self._open[rec.rid] = rec

    def on_terminate(self, rid: int, t: float):
        rec = self._open.pop(rid, None)
        if rec is not None:
            rec.t_end = t

    def on_interruption(self, rid: int, t: float, overhead_s: float = 0.0):
        """A spot notice forced ``rid`` to drain (checkpoint+restore cost
        ``overhead_s`` engine-seconds of migration work)."""
        self.interruptions += 1
        self.interruption_overhead_s += overhead_s
        rec = self._open.get(rid)
        if rec is None:                     # already retired: find latest
            recs = [r for r in self.purchases if r.rid == rid]
            rec = recs[-1] if recs else None
        if rec is not None:
            rec.interrupted_t = t

    # ---------------------------------------------------------- billing
    def _span(self, rec: PurchaseRecord, horizon: float):
        end = rec.t_end if rec.t_end is not None else horizon
        return rec.t_buy, max(end, rec.t_buy)

    def purchase_dollars(self, rec: PurchaseRecord, horizon: float) -> float:
        t0, t1 = self._span(rec, horizon)
        if rec.spot:
            return self.catalog.market(rec.market).dollars(t0, t1)
        return rec.on_demand_rate * (t1 - t0) / 3600.0

    def actual_dollars(self, horizon: float) -> float:
        return sum(self.purchase_dollars(r, horizon) for r in self.purchases)

    def on_demand_dollars(self, horizon: float) -> float:
        """Counterfactual: same instances, same holding periods, all
        bought at their guaranteed on-demand rate."""
        return sum(r.on_demand_rate * (self._span(r, horizon)[1]
                                       - self._span(r, horizon)[0]) / 3600.0
                   for r in self.purchases)

    def savings_pct(self, horizon: float) -> float:
        od = self.on_demand_dollars(horizon)
        if od <= 0:
            return 0.0
        return 100.0 * (od - self.actual_dollars(horizon)) / od

    # ---------------------------------------------------------- reports
    def by_market(self, horizon: float) -> Dict[str, Dict[str, float]]:
        # every catalog market appears (zero-filled) so the report's key
        # set is stable across runs that never touched a market
        out: Dict[str, Dict[str, float]] = {
            m.name: {"purchases": 0, "dollars": 0.0, "interruptions": 0}
            for m in self.catalog.markets()}
        for rec in self.purchases:
            row = out.setdefault(rec.market, {
                "purchases": 0, "dollars": 0.0, "interruptions": 0})
            row["purchases"] += 1
            row["dollars"] += self.purchase_dollars(rec, horizon)
            row["interruptions"] += int(rec.interrupted_t is not None)
        return out

    def by_strategy(self) -> Dict[str, int]:
        out: Dict[str, int] = {"initial": 0}
        for rec in self.purchases:
            out[rec.strategy] = out.get(rec.strategy, 0) + 1
        return out

    def report(self, horizon: float) -> Dict[str, float]:
        """Flat dict merged into ``ClusterMetrics.summary()``."""
        out = {
            "market_dollar_cost": round(self.actual_dollars(horizon), 6),
            "on_demand_dollar_cost": round(
                self.on_demand_dollars(horizon), 6),
            "savings_pct": round(self.savings_pct(horizon), 3),
            "spot_interruptions": self.interruptions,
            "spot_interruption_overhead_s": round(
                self.interruption_overhead_s, 3),
            "purchases": len(self.purchases),
        }
        for market, row in sorted(self.by_market(horizon).items()):
            out[f"market_{market}_purchases"] = row["purchases"]
            out[f"market_{market}_dollars"] = round(row["dollars"], 6)
            out[f"market_{market}_interruptions"] = row["interruptions"]
        for strategy, n in sorted(self.by_strategy().items()):
            out[f"strategy_{strategy}_purchases"] = n
        return out
