"""Synthetic serving workloads shared by benchmarks, tests, and CLIs.

Port of ``repro.serving.workload``: the same numpy streams, so both
packages draw the same requests and arrivals from one seed.

Besides the request generator, this module defines:

* the per-request ``SLOClass`` vocabulary (deadline + priority) the
  cluster's admission/routing layer consumes;
* the open-loop ``ArrivalProcess`` family: iterables of
  ``(arrival_t, Request)`` that a ``ServingCluster`` consumes one event
  at a time (each arrival schedules the next), so load is offered at a
  rate independent of service progress;
* the closed-loop ``ClosedLoopThinkTime`` process: ``n_users``
  concurrent sessions, each re-arming its next arrival an exponential
  think time after its previous request completes — offered load tracks
  completions instead of an external clock.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.engine import Request


# ----------------------------------------------------------------- SLOs
@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A service-level objective: completion deadline + admission rank.

    ``priority`` orders admission and routing (lower = more urgent —
    interactive requests queue-jump batch ones); ``deadline`` is the
    per-request completion budget in virtual seconds from arrival
    (``inf`` = best-effort).  ``admit_lazily`` marks classes that should
    only be admitted while the fleet has backlog headroom, so they never
    crowd out latency-sensitive work.
    """
    name: str
    priority: int
    deadline: float = math.inf
    admit_lazily: bool = False


INTERACTIVE = SLOClass("interactive", 0, deadline=15.0)
STANDARD = SLOClass("standard", 1)
BATCH = SLOClass("batch", 2, deadline=300.0, admit_lazily=True)
SLO_CLASSES = {c.name: c for c in (INTERACTIVE, STANDARD, BATCH)}


def synthetic_requests(n: int, vocab_size: int, *, seed: int = 0,
                       prompt_len: Tuple[int, int] = (3, 9),
                       max_new: Union[int, Tuple[int, int]] = (4, 10),
                       start_rid: int = 0) -> List[Request]:
    """``n`` random-token requests; lengths drawn from half-open ranges."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(start_rid, start_rid + n):
        plen = int(rng.integers(*prompt_len))
        new = max_new if isinstance(max_new, int) \
            else int(rng.integers(*max_new))
        reqs.append(Request(rid=rid,
                            prompt=rng.integers(0, vocab_size, plen,
                                                dtype=np.int32),
                            max_new_tokens=new))
    return reqs


def prefill_heavy_requests(n: int, vocab_size: int, *, prompt_len: int = 64,
                           max_new: int = 8, seed: int = 0,
                           start_rid: int = 0) -> List[Request]:
    """Fixed-length long-prompt requests: the prefill-dominated workload
    the chunked-bulk-prefill path is measured on (``engine_throughput``).
    All prompts share one length so streamed-vs-chunked timing isolates
    the prefill strategy, not workload variance."""
    rng = np.random.default_rng(seed)
    return [Request(rid=rid,
                    prompt=rng.integers(0, vocab_size, prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=max_new)
            for rid in range(start_rid, start_rid + n)]


def classed_requests(n: int, vocab_size: int, *, interactive_frac: float = 0.5,
                     seed: int = 0, start_rid: int = 0,
                     interactive: SLOClass = INTERACTIVE,
                     batch: SLOClass = BATCH,
                     interactive_shape: Tuple[Tuple[int, int],
                                              Tuple[int, int]] = ((3, 8),
                                                                  (3, 7)),
                     batch_shape: Tuple[Tuple[int, int],
                                        Tuple[int, int]] = ((6, 14),
                                                            (10, 18)),
                     model_ids: Sequence[str] = ("default",)
                     ) -> List[Request]:
    """A seeded interactive/batch request mix for SLO scenarios.

    Interactive requests are short (chat-turn shaped) with a tight
    deadline; batch requests are longer (summarize/extract shaped) with a
    loose one.  ``model_ids`` round-robins requests over a multi-model
    fleet's pools; shapes are ``((plen_lo, plen_hi), (new_lo, new_hi))``
    half-open ranges.
    """
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(start_rid, start_rid + n):
        if rng.random() < interactive_frac:
            (plo, phi), (nlo, nhi) = interactive_shape
            slo = interactive
        else:
            (plo, phi), (nlo, nhi) = batch_shape
            slo = batch
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab_size, int(rng.integers(plo, phi)),
                                dtype=np.int32),
            max_new_tokens=int(rng.integers(nlo, nhi)),
            slo=slo,
            model_id=model_ids[rid % len(model_ids)]))
    return reqs


# ------------------------------------------------------------- arrivals
class ArrivalProcess:
    """Iterable of ``(arrival_t, Request)`` pairs, time-ordered."""

    def __iter__(self) -> Iterator[Tuple[float, Request]]:
        raise NotImplementedError


class BatchArrivals(ArrivalProcess):
    """Closed-loop baseline: the whole batch is submitted at ``t0``."""

    def __init__(self, requests: Sequence[Request], t0: float = 0.0):
        self.requests = list(requests)
        self.t0 = t0

    def __iter__(self):
        for req in self.requests:
            yield self.t0, req


class PoissonArrivals(ArrivalProcess):
    """Open-loop Poisson process: seeded exponential inter-arrival gaps
    at ``rate`` requests per virtual second."""

    def __init__(self, requests: Sequence[Request], rate: float, *,
                 seed: int = 0, t0: float = 0.0):
        if rate <= 0:
            raise ValueError(f"poisson arrival rate must be > 0, got {rate}")
        self.requests = list(requests)
        self.rate = rate
        self.seed = seed
        self.t0 = t0

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        t = self.t0
        for req in self.requests:
            t += float(rng.exponential(1.0 / self.rate))
            yield t, req


class TraceArrivals(ArrivalProcess):
    """Trace-driven arrivals: explicit timestamps, one per request.

    A trace shorter than the request list truncates it; extra timestamps
    are ignored.
    """

    def __init__(self, requests: Sequence[Request],
                 times: Sequence[float]):
        self.requests = list(requests)
        self.times = sorted(float(t) for t in times)

    @classmethod
    def from_file(cls, path: str,
                  requests: Sequence[Request]) -> "TraceArrivals":
        """Trace file: one arrival timestamp per line (# comments)."""
        times = []
        with open(path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if line:
                    times.append(float(line))
        return cls(requests, times)

    def __iter__(self):
        for t, req in zip(self.times, self.requests):
            yield t, req


# ----------------------------------------------------------- closed loop
class ClosedLoopThinkTime:
    """Closed-loop offered load: ``n_users`` concurrent sessions.

    Each session submits one request at a time; when its request
    completes at ``t`` the next one arrives at ``t + Exp(think_mean)``.
    Unlike the open-loop processes, offered load *tracks completions* —
    a saturated fleet sees at most ``n_users`` requests in flight, and a
    faster fleet is offered proportionally more load.

    Protocol (consumed by ``ServingCluster.attach_closed_loop``):

    * ``initial()``            — the first ``n_users`` arrivals at ``t0``;
    * ``on_complete(req, t)``  — called at every request completion;
                                 returns ``(t_next, next_request)`` or
                                 ``None`` when the session list is spent.

    ``issued`` / ``completed`` log ``(t, rid)`` pairs so tests can assert
    the in-flight population never exceeds ``n_users`` and every re-arm
    strictly follows the completion that triggered it.
    """

    def __init__(self, requests: Sequence[Request], *, n_users: int = 2,
                 think_mean: float = 1.0, seed: int = 0, t0: float = 0.0):
        if think_mean < 0:
            raise ValueError(f"think_mean must be >= 0, got {think_mean}")
        self.requests = list(requests)
        self.n_users = max(int(n_users), 1)
        self.think_mean = float(think_mean)
        self.t0 = t0
        self._rng = np.random.default_rng(seed)
        self._next = 0
        self._outstanding: set = set()   # rids this process issued, live
        self.issued: List[Tuple[float, int]] = []
        self.completed: List[Tuple[float, int]] = []

    def initial(self) -> List[Tuple[float, Request]]:
        first = []
        while self._next < min(self.n_users, len(self.requests)):
            req = self.requests[self._next]
            self._next += 1
            first.append((self.t0, req))
            self.issued.append((self.t0, req.rid))
            self._outstanding.add(req.rid)
        return first

    def on_complete(self, req: Request,
                    t: float) -> Optional[Tuple[float, Request]]:
        # the cluster fires completion hooks for EVERY finished request;
        # a session only frees when one of OUR requests completes —
        # foreign (open-loop / submitted) traffic must not re-arm us
        if req.rid not in self._outstanding:
            return None
        self._outstanding.discard(req.rid)
        self.completed.append((t, req.rid))
        if self._next >= len(self.requests):
            return None
        nxt = self.requests[self._next]
        self._next += 1
        t_next = t + float(self._rng.exponential(self.think_mean)) \
            if self.think_mean > 0 else t
        self.issued.append((t_next, nxt.rid))
        self._outstanding.add(nxt.rid)
        return t_next, nxt


def make_arrivals(spec: str, requests: Sequence[Request], *,
                  seed: int = 0) -> ArrivalProcess:
    """Build an arrival process from a CLI spec.

    ``batch`` | ``poisson:<rate>`` | ``trace:<file>``
    """
    if spec == "batch":
        return BatchArrivals(requests)
    kind, _, arg = spec.partition(":")
    if kind == "poisson" and arg:
        return PoissonArrivals(requests, float(arg), seed=seed)
    if kind == "trace" and arg:
        return TraceArrivals.from_file(arg, requests)
    raise ValueError(
        f"unknown arrival spec {spec!r}; "
        f"expected batch | poisson:<rate> | trace:<file>")
