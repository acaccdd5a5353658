"""Fallback strategies: where capacity comes from after a spot notice.

When a market interruption fires its ``rebalance_recommendation``, the
autoscaler asks the control plane's :class:`FallbackStrategy` for a
:class:`PurchaseOrder` — which hardware to buy, in which market — and
pre-warms the replacement so it is ready before the doomed replica's
``terminate``.  The packed WorkUnits then land wherever the router's
readmission places them, replacement included.

The strategy set mirrors the ShieldOps taxonomy:

* ``on_demand``         — buy the same hardware at the guaranteed rate;
                          dearest, never interrupted again.
* ``different_market``  — same hardware in the best *other* market
                          (on-demand if the interrupted market was the
                          only listing).
* ``different_type``    — best (itype, market) offer across the whole
                          catalog for the replica's model.
* ``queue_work``        — no replacement; drained units wait for free
                          slots on surviving replicas.
* ``scale_down``        — no replacement; drained units spread across
                          survivors immediately (accept the squeeze).

Port of ``repro.market.fallback``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Type, Union

from repro_torch.cluster.replica import InstanceType
from repro_torch.market.catalog import ON_DEMAND
from repro_torch.market.exchange import SpotExchange


@dataclasses.dataclass(frozen=True)
class PurchaseOrder:
    """What the fallback wants bought."""
    itype: InstanceType
    market: str          # market name or ON_DEMAND


class FallbackStrategy:
    """Policy seam: spot notice -> optional replacement purchase."""

    name = "base"
    #: When True, drained units are only re-admitted onto replicas with
    #: free slots (they queue rather than pile onto busy engines).
    queue_until_free = False

    def replacement(self, view, rep, exchange: SpotExchange,
                    now: float) -> Optional[PurchaseOrder]:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class OnDemandFallback(FallbackStrategy):
    name = "on_demand"

    def replacement(self, view, rep, exchange, now):
        return PurchaseOrder(rep.itype, ON_DEMAND)


class DifferentMarketFallback(FallbackStrategy):
    name = "different_market"

    def replacement(self, view, rep, exchange, now):
        bought = rep.purchase.market if rep.purchase is not None else None
        exclude = {bought} if bought else set()
        market = exchange.best_market(rep.itype, now, exclude=exclude)
        return PurchaseOrder(rep.itype, market or ON_DEMAND)


class DifferentTypeFallback(FallbackStrategy):
    name = "different_type"

    def replacement(self, view, rep, exchange, now):
        offer = exchange.best_offer(rep.model_id, now, exclude_itype=rep.itype)
        if offer is not None:
            return PurchaseOrder(*offer)
        # nothing else in the catalog serves this model: next-best market
        # for the same hardware, on-demand as the floor
        return DifferentMarketFallback().replacement(view, rep, exchange, now)


class QueueWorkFallback(FallbackStrategy):
    name = "queue_work"
    queue_until_free = True

    def replacement(self, view, rep, exchange, now):
        return None


class ScaleDownFallback(FallbackStrategy):
    name = "scale_down"

    def replacement(self, view, rep, exchange, now):
        return None


FALLBACKS: Dict[str, Type[FallbackStrategy]] = {
    cls.name: cls for cls in (
        OnDemandFallback, DifferentMarketFallback, DifferentTypeFallback,
        QueueWorkFallback, ScaleDownFallback)}


def make_fallback(spec: Union[str, FallbackStrategy, None]
                  ) -> Optional[FallbackStrategy]:
    if spec is None or isinstance(spec, FallbackStrategy):
        return spec
    try:
        return FALLBACKS[spec]()
    except KeyError:
        raise ValueError(f"unknown fallback {spec!r}; pick from "
                         f"{sorted(FALLBACKS)}") from None
