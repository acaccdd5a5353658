"""Instance-type listings: which markets sell which hardware, at what
on-demand rate.

A :class:`MarketCatalog` maps each :class:`InstanceType` to its
purchase options — zero or more spot markets (cheap, volatile, may be
interrupted) plus a guaranteed on-demand rate (expensive, never
interrupted).  ``InstanceType.cost_per_hour`` stays what it always was
(the static accounting rate used by ``ClusterMetrics``); the catalog's
``on_demand_rate`` is the *market* price of the no-risk option and
defaults to it.

Port of ``repro.market.catalog``, keyed on the port's
``cluster.replica.InstanceType``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.cluster.replica import InstanceType
from repro_torch.market.market import SpotMarket

#: Market name reserved for the never-interrupted option.
ON_DEMAND = "on_demand"


@dataclasses.dataclass(frozen=True)
class Listing:
    """Purchase options for one instance type."""
    itype: InstanceType
    on_demand_rate: float
    markets: Tuple[str, ...] = ()


class MarketCatalog:
    """Registry of spot markets + per-instance-type listings."""

    def __init__(self):
        self._markets: Dict[str, SpotMarket] = {}
        self._listings: Dict[str, Listing] = {}

    # ------------------------------------------------------------ build
    def add_market(self, market: SpotMarket) -> SpotMarket:
        if market.name == ON_DEMAND:
            raise ValueError(f"{ON_DEMAND!r} is reserved")
        if market.name in self._markets:
            raise ValueError(f"market {market.name!r} already registered")
        self._markets[market.name] = market
        return market

    def list_instance(self, itype: InstanceType, *,
                      on_demand_rate: Optional[float] = None,
                      markets: Tuple[str, ...] = ()) -> Listing:
        for m in markets:
            if m not in self._markets:
                raise KeyError(f"unknown market {m!r} (add_market first)")
        rate = (itype.cost_per_hour if on_demand_rate is None
                else float(on_demand_rate))
        listing = Listing(itype, rate, tuple(markets))
        self._listings[itype.name] = listing
        return listing

    # ---------------------------------------------------------- queries
    def market(self, name: str) -> SpotMarket:
        try:
            return self._markets[name]
        except KeyError:
            raise KeyError(f"unknown market {name!r}; have "
                           f"{sorted(self._markets)}") from None

    def markets(self) -> List[SpotMarket]:
        return list(self._markets.values())

    def listing(self, itype: Union[InstanceType, str]) -> Listing:
        name = itype if isinstance(itype, str) else itype.name
        try:
            return self._listings[name]
        except KeyError:
            raise KeyError(f"instance type {name!r} not listed; have "
                           f"{sorted(self._listings)}") from None

    def itypes(self, model_id: Optional[str] = None) -> List[InstanceType]:
        out = [l.itype for l in self._listings.values()]
        if model_id is not None:
            out = [it for it in out if it.model_id == model_id]
        return out

    def markets_for(self, itype: Union[InstanceType, str]) -> Tuple[str, ...]:
        return self.listing(itype).markets

    def on_demand_rate(self, itype: Union[InstanceType, str]) -> float:
        return self.listing(itype).on_demand_rate
