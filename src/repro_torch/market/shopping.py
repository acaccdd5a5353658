"""Market-aware autoscaling: shop live prices, not static ones.

:class:`MarketAwareScaling` keeps ``CostAwareScaling``'s grow/shrink
triggers but reprices every launch decision through the exchange: the
winning (itype, market) maximizes speed per *effective* dollar, where
the effective price in ``adjusted`` mode folds in the market's
predicted interruption rate times the dollar cost of one interruption
(drain + re-prefill overhead, learned from ``ClusterMetrics`` drain
records, billed at the on-demand rate).  The actual market is chosen
again at ``ServingCluster.launch`` time via ``market="auto"`` — the
exchange is the single pricing authority, so policy and purchase can
never disagree.

Port of ``repro.market.shopping``, over the port's ``CostAwareScaling``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.cluster.control import ClusterView, CostAwareScaling
from repro_torch.cluster.replica import InstanceType, Replica
from repro_torch.market.exchange import SpotExchange


class MarketAwareScaling(CostAwareScaling):
    name = "market"

    def __init__(self, exchange: SpotExchange, **kw):
        catalog = exchange.catalog.itypes()
        if not catalog:
            raise ValueError("MarketAwareScaling needs a listed catalog")
        super().__init__(catalog, **kw)
        self.exchange = exchange

    def select_itype(self, view: ClusterView, model_id: str,
                     serving: Sequence[Replica]) -> InstanceType:
        offer = self.exchange.best_offer(model_id, view.now)
        if offer is None:
            return super().select_itype(view, model_id, serving)
        itype, market = offer
        price = self.exchange.effective_price(itype, market, view.now)
        view.log(f"scale_up pool={model_id}: market pick {itype.name} @ "
                 f"{market} (eff ${price:.2f}/h, {self.exchange.mode})")
        return itype

    def replacement(self, view: ClusterView, rep: Replica) -> InstanceType:
        offer = self.exchange.best_offer(rep.model_id, view.now)
        return offer[0] if offer is not None else rep.itype
