"""Load-balancing strategies (Charm++ suite, rate-aware).

Objects (chares/tiles) carry measured loads; PEs carry measured rates.  A
strategy returns an assignment ``obj -> pe`` minimizing the *rate-weighted*
makespan  max_pe( sum_{obj on pe} load(obj) / rate(pe) ).

Strategies:

* ``greedy``        — classic Charm++ GreedyLB: heaviest object to the PE
                      that finishes it earliest. Ignores current placement
                      (migrates nearly everything).
* ``greedy_refine`` — the paper's GreedyRefine: keep objects home unless a
                      PE is overloaded; move the minimum number of objects
                      from overloaded PEs to the least-loaded PEs. Minimizes
                      migrations and preserves communication locality.
* ``none``          — identity (the paper's no-LB baseline).

All strategies are rate-aware iff given non-uniform ``rates``; with
rates=None they reduce to the homogeneous Charm++ equivalents.

A numpy copy of ``repro/core/loadbalance.py``: the port imports nothing
of ``repro``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class LBResult:
    assignment: np.ndarray          # (n_objs,) -> pe
    migrations: int                 # objs moved vs current placement
    makespan: float                 # rate-weighted
    baseline_makespan: float        # makespan of the input placement


def _makespan(assignment, loads, rates, base=None) -> float:
    n_pes = len(rates)
    per_pe = np.zeros(n_pes) if base is None \
        else np.asarray(base, dtype=np.float64).copy()
    np.add.at(per_pe, assignment, loads)
    return float((per_pe / rates).max())


def _norm_base(base, n_pes) -> np.ndarray:
    if base is None:
        return np.zeros(n_pes)
    b = np.asarray(base, dtype=np.float64)
    assert len(b) == n_pes
    return b


def _norm_rates(rates, n_pes) -> np.ndarray:
    if rates is None:
        return np.ones(n_pes)
    r = np.asarray(rates, dtype=np.float64)
    assert len(r) == n_pes
    return np.maximum(r, 1e-9)


def greedy(loads: Sequence[float], n_pes: int,
           rates: Optional[Sequence[float]] = None,
           current: Optional[Sequence[int]] = None,
           base: Optional[Sequence[float]] = None) -> LBResult:
    """GreedyLB: heaviest-first onto earliest-finishing PE.

    ``base`` is optional non-migratable load already committed to each PE
    (e.g. in-flight serving requests pinned to their replica); PEs start
    from ``base[pe]/rates[pe]`` instead of zero.
    """
    loads = np.asarray(loads, dtype=np.float64)
    rates = _norm_rates(rates, n_pes)
    base = _norm_base(base, n_pes)
    order = np.argsort(-loads)
    finish = [(base[pe] / rates[pe], pe) for pe in range(n_pes)]
    heapq.heapify(finish)
    assignment = np.zeros(len(loads), dtype=np.int64)
    for obj in order:
        t, pe = heapq.heappop(finish)
        assignment[obj] = pe
        heapq.heappush(finish, (t + loads[obj] / rates[pe], pe))
    cur = (np.asarray(current, dtype=np.int64) if current is not None
           else assignment)
    return LBResult(
        assignment=assignment,
        migrations=int((assignment != cur).sum()),
        makespan=_makespan(assignment, loads, rates, base),
        baseline_makespan=_makespan(cur, loads, rates, base),
    )


def greedy_refine(loads: Sequence[float], n_pes: int,
                  rates: Optional[Sequence[float]] = None,
                  current: Optional[Sequence[int]] = None,
                  tolerance: float = 1.05,
                  base: Optional[Sequence[float]] = None) -> LBResult:
    """GreedyRefine: migrate as few objects as possible.

    PEs with scaled load above ``tolerance * ideal`` donate their smallest
    objects; donations go to the PE that would finish them earliest.
    ``base`` is non-migratable per-PE load (see ``greedy``).
    """
    loads = np.asarray(loads, dtype=np.float64)
    n_objs = len(loads)
    rates = _norm_rates(rates, n_pes)
    base = _norm_base(base, n_pes)
    if current is None:
        # no placement yet: fall back to greedy (initial map)
        return greedy(loads, n_pes, rates, base=base)
    assignment = np.asarray(current, dtype=np.int64).copy()
    baseline = _makespan(assignment, loads, rates, base)

    per_pe = base.copy()
    np.add.at(per_pe, assignment, loads)
    scaled = per_pe / rates
    ideal = (loads.sum() + base.sum()) / rates.sum()
    threshold = tolerance * ideal

    # objects on overloaded PEs, lightest first (cheapest migrations first)
    donors = [pe for pe in range(n_pes) if scaled[pe] > threshold]
    moved = 0
    for pe in sorted(donors, key=lambda q: -scaled[q]):
        objs = [o for o in np.nonzero(assignment == pe)[0]]
        objs.sort(key=lambda o: loads[o])
        for o in objs:
            if scaled[pe] <= threshold:
                break
            # candidate receiver: minimal scaled load after receiving
            cand = np.argmin((per_pe + loads[o]) / rates)
            if cand == pe:
                break
            new_scaled = (per_pe[cand] + loads[o]) / rates[cand]
            if new_scaled >= scaled[pe]:   # would not help
                continue
            assignment[o] = cand
            per_pe[pe] -= loads[o]
            per_pe[cand] += loads[o]
            scaled[pe] = per_pe[pe] / rates[pe]
            scaled[cand] = per_pe[cand] / rates[cand]
            moved += 1
    return LBResult(
        assignment=assignment,
        migrations=moved,
        makespan=_makespan(assignment, loads, rates, base),
        baseline_makespan=baseline,
    )


def no_lb(loads: Sequence[float], n_pes: int,
          rates: Optional[Sequence[float]] = None,
          current: Optional[Sequence[int]] = None) -> LBResult:
    loads = np.asarray(loads, dtype=np.float64)
    rates = _norm_rates(rates, n_pes)
    if current is None:
        current = np.arange(len(loads)) % n_pes     # block-cyclic home
    cur = np.asarray(current, dtype=np.int64)
    ms = _makespan(cur, loads, rates)
    return LBResult(cur, 0, ms, ms)


STRATEGIES = {
    "greedy": greedy,
    "greedy_refine": greedy_refine,
    "none": no_lb,
}


def balance(strategy: str, loads, n_pes, rates=None, current=None,
            **kw) -> LBResult:
    return STRATEGIES[strategy](loads, n_pes, rates=rates, current=current,
                                **kw)
