"""Rate monitoring — the measured inputs to rate-aware load balancing.

Charm++'s runtime records per-PE load and speed; here a ``RateMonitor``
keeps an EWMA of measured per-PE throughput (work-units/second).  On
heterogeneous cloud fleets the *rates differ per instance type* (paper
§III-B); the balancer consumes ``rates()``, never ground-truth hardware
specs -- stragglers and multi-tenant jitter show up the same way.

A numpy copy of ``repro/core/rates.py``: the port imports nothing
of ``repro``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class RateMonitor:
    def __init__(self, n_pes: int, alpha: float = 0.3):
        self.n_pes = n_pes
        self.alpha = alpha
        self._rate = np.ones(n_pes, dtype=np.float64)
        self._seen = np.zeros(n_pes, dtype=bool)

    def record(self, pe: int, work_units: float, seconds: float):
        if seconds <= 0:
            return
        r = work_units / seconds
        if not self._seen[pe]:
            self._rate[pe] = r
            self._seen[pe] = True
        else:
            self._rate[pe] = (1 - self.alpha) * self._rate[pe] + \
                self.alpha * r

    def record_step(self, per_pe_work: Sequence[float],
                    per_pe_seconds: Sequence[float]):
        for pe, (w, s) in enumerate(zip(per_pe_work, per_pe_seconds)):
            self.record(pe, w, s)

    def rates(self) -> np.ndarray:
        """Normalized rates (mean 1.0). Unseen PEs assume average speed."""
        r = self._rate.copy()
        if self._seen.any():
            r[~self._seen] = r[self._seen].mean()
        return r / max(r.mean(), 1e-12)

    def resize(self, n_pes: int):
        """Elastic shrink/expand keeps overlapping PE history."""
        old_r, old_s = self._rate, self._seen
        self._rate = np.ones(n_pes, dtype=np.float64)
        self._seen = np.zeros(n_pes, dtype=bool)
        n = min(n_pes, len(old_r))
        self._rate[:n] = old_r[:n]
        self._seen[:n] = old_s[:n]
        self.n_pes = n_pes

    def straggler_pes(self, threshold: float = 0.7) -> List[int]:
        """PEs persistently slower than ``threshold`` x mean rate."""
        r = self.rates()
        return [int(i) for i in np.nonzero(r < threshold)[0]]
