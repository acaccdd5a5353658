"""Spot-market economics for the serving fleet (paper §IV follow-up).

The cloud as a priced economy: :class:`SpotMarket` rate processes
drive both the bill and the interruption schedule, a
:class:`MarketCatalog` lists the purchase options per instance type,
the :class:`SpotExchange` quotes naive vs interruption-adjusted
prices and executes buys, :class:`FallbackStrategy` decides where
capacity comes from after a spot notice, and the
:class:`SavingsLedger` reports savings vs all-on-demand through
``ClusterMetrics.summary()``.

Port of ``repro.market``, host code (Python and numpy) with the same
names: seeded markets give the reference's prices, interruption times
and dollars bit for bit.
"""

from repro_torch.market.catalog import Listing, MarketCatalog, ON_DEMAND
from repro_torch.market.exchange import AUTO, SpotExchange
from repro_torch.market.fallback import (FALLBACKS,
                                         DifferentMarketFallback,
                                         DifferentTypeFallback,
                                         FallbackStrategy, OnDemandFallback,
                                         PurchaseOrder, QueueWorkFallback,
                                         ScaleDownFallback, make_fallback)
from repro_torch.market.ledger import PurchaseRecord, SavingsLedger
from repro_torch.market.market import SpotMarket
from repro_torch.market.shopping import MarketAwareScaling

__all__ = [
    "AUTO", "ON_DEMAND", "FALLBACKS",
    "SpotMarket", "MarketCatalog", "Listing",
    "SpotExchange", "PurchaseRecord", "SavingsLedger",
    "FallbackStrategy", "PurchaseOrder", "make_fallback",
    "OnDemandFallback", "DifferentMarketFallback", "DifferentTypeFallback",
    "QueueWorkFallback", "ScaleDownFallback",
    "MarketAwareScaling",
]
