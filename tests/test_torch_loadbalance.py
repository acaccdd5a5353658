"""The port's load balancers against the JAX package's, and properties that
hold of them, on a fixed list of seeds (no randomised search: each case
runs the same inputs every time).

* ``greedy``, ``greedy_refine``, ``none`` and ``balance`` give the same
  assignment, migrations and makespans as JAX's on seeded loads, rates,
  placements and pinned base loads.
* LPT (``greedy``) is a list schedule, so its makespan is at most
  ``sum(loads) / n_pes + max(loads)``.  The tighter-looking
  ``4/3 * max(mean, max)`` is not a property of it: the 4/3 factor bounds
  LPT against the *optimum*, and the optimum can exceed that lower bound
  (five loads of 1.0 on 4 PEs: makespan 2, bound 1.67).
* Rate-aware LPT lies between ``sum(loads) / sum(rates)`` and the serial
  time on the slowest PE; ``no_lb`` keeps the placement it is given.
"""

import numpy as np
import pytest

from repro.core import loadbalance as jlb
from repro_torch.core import loadbalance as lb

SEEDS = list(range(12))


def _case(seed):
    """Loads, PE count, rates, a current placement and base loads."""
    rng = np.random.default_rng(seed)
    n_pes = int(rng.integers(2, 9))
    loads = rng.uniform(0.1, 10.0, int(rng.integers(4, 65)))
    if seed % 3 == 0:
        loads = np.ones(len(loads))        # the stencil apps' uniform tiles
    rates = rng.uniform(0.2, 2.0, n_pes)
    current = rng.integers(0, n_pes, len(loads))
    base = rng.uniform(0.0, 5.0, n_pes)
    return loads, n_pes, rates, current, base


def _same(a, b):
    np.testing.assert_array_equal(a.assignment, b.assignment)
    assert a.migrations == b.migrations
    assert a.makespan == b.makespan
    assert a.baseline_makespan == b.baseline_makespan


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("strategy", ["greedy", "greedy_refine", "none"])
def test_strategies_equal_jax(strategy, seed):
    loads, n_pes, rates, current, base = _case(seed)
    for r in (None, rates):
        for cur in (None, current):
            _same(lb.balance(strategy, loads, n_pes, rates=r, current=cur),
                  jlb.balance(strategy, loads, n_pes, rates=r, current=cur))
    if strategy != "none":
        _same(lb.STRATEGIES[strategy](loads, n_pes, rates, current,
                                      base=base),
              jlb.STRATEGIES[strategy](loads, n_pes, rates, current,
                                       base=base))


@pytest.mark.parametrize("seed", SEEDS)
def test_greedy_is_a_list_schedule(seed):
    loads, n_pes, _, current, _ = _case(seed)
    res = lb.greedy(loads, n_pes, current=current)
    assert res.assignment.shape == (len(loads),)
    assert res.assignment.min() >= 0 and res.assignment.max() < n_pes
    assert res.migrations == int((res.assignment != current).sum())
    assert res.makespan <= sum(loads) / n_pes + max(loads) + 1e-9
    assert res.makespan >= max(sum(loads) / n_pes, max(loads)) - 1e-9


def test_five_unit_loads_on_four_pes_exceed_four_thirds_of_the_bound():
    """The optimum itself is 2 here: the 4/3 * max(mean, max) bound of
    ``tests/test_loadbalance.py`` (1.67) is false, the list bound true."""
    loads = np.ones(5)
    res = lb.greedy(loads, 4)
    assert res.makespan == 2.0
    assert res.makespan > (4 / 3) * max(loads.sum() / 4, loads.max())
    assert res.makespan <= loads.sum() / 4 + loads.max()
    assert jlb.greedy(loads, 4).makespan == 2.0


@pytest.mark.parametrize("seed", SEEDS)
def test_greedy_refine_never_worse_and_moves_only_off_donors(seed):
    loads, n_pes, rates, current, _ = _case(seed)
    for r in (None, rates):
        res = lb.greedy_refine(loads, n_pes, rates=r, current=current)
        assert res.makespan <= res.baseline_makespan + 1e-9
        moved = np.nonzero(res.assignment != current)[0]
        assert res.migrations == len(moved)
        rr = np.ones(n_pes) if r is None else r
        scaled = np.zeros(n_pes)
        np.add.at(scaled, current, loads)
        scaled /= rr
        ideal = loads.sum() / rr.sum()
        assert all(scaled[current[o]] > 1.05 * ideal for o in moved)


def test_rate_aware_moves_work_off_slow_pe():
    loads = np.ones(16)
    rates = [1.0, 1.0, 0.25, 1.0]
    res = lb.greedy(loads, 4, rates=rates)
    counts = np.bincount(res.assignment, minlength=4)
    assert counts[2] == counts.min() and counts[2] <= 2
    blind = lb.greedy(loads, 4)
    assert res.makespan < lb._makespan(blind.assignment, loads,
                                       np.asarray(rates))


def test_greedy_refine_keeps_balanced_assignment():
    current = np.arange(16) % 4
    res = lb.greedy_refine(np.ones(16), 4, current=current)
    assert res.migrations == 0
    np.testing.assert_array_equal(res.assignment, current)


@pytest.mark.parametrize("seed", SEEDS)
def test_rate_aware_greedy_bounds(seed):
    """Rate-aware LPT lies between the ideal ``sum(loads) / sum(rates)``
    and the serial time on the slowest PE."""
    loads, n_pes, rates, _, _ = _case(seed)
    res = lb.greedy(loads, n_pes, rates=rates)
    assert res.makespan >= loads.sum() / rates.sum() - 1e-9
    assert res.makespan <= loads.sum() / rates.min() + 1e-9


def test_no_lb_is_identity():
    loads = np.ones(8)
    cur = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    res = lb.no_lb(loads, 2, current=cur)
    assert np.array_equal(res.assignment, cur)
    assert res.migrations == 0
