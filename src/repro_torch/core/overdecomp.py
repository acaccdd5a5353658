"""Overdecomposed tile runtime — chare collections for stencil apps (C1).

The global 2D domain is decomposed into ``odf x n_pes`` tiles ("chares").
Tiles are migratable units: the runtime owns a tile->PE map produced by the
load balancer, measures per-PE execution rates, and exposes
checkpoint/restore hooks for elasticity.

The port of ``repro/core/overdecomp.py``.  What differs inside:

* **Tiles live on the device**, as one ``(n_tiles, h, w)`` tensor with a
  second buffer: a step reads one and writes the other, then swaps.  The
  neighbour table is built on the device once; each PE's tile ids are
  cached there and rebuilt only when the assignment changes.  A Jacobi
  step is one launch of the stencil kernel per PE that holds tiles, with
  its halos read from the neighbour tiles in place (no gather, no host
  copy).
* **Per-PE seconds are device time** on the card: CUDA events around each
  PE's launch, read after one synchronisation at the end of the step (the
  step's only host sync; ``host_syncs`` counts them).  On the CPU they
  come from ``time.perf_counter``.  The reference keeps each PE step's
  first run at a new tile count out of the timing, for XLA's compile.
  Here only a step of plain torch ops does (the LULESH proxy, and Jacobi
  on the CPU): its first run loads the ops' kernels and grows the
  allocator.  The stencil kernel is loaded onto the card with its
  library and timed from its first launch.
* **The host-facing forms stay host numpy**: ``checkpoint()``,
  ``restore()`` and ``global_grid()`` take and give the reference's form
  (a dict of numpy tiles, the assignment, the iteration), so a snapshot
  of either package restores into the other.  bf16 tiles travel as
  float32 numpy (exact both ways).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import loadbalance as lb
from repro_torch.core.rates import RateMonitor
from repro_torch.device import resolve_device
from repro_torch.kernels.jacobi import prepare_jacobi_tiles
from repro_torch.kernels.jacobi.ref import (  # noqa: F401
    jacobi_tile_step, neighbour_sum, tile_halos)
from repro_torch.runtime import EventLoop, FaultTrace


# --------------------------------------------------------------------- tiles
@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Decomposition of an (H, W) domain into (tr x tc) tiles."""
    H: int
    W: int
    tr: int
    tc: int

    @property
    def n_tiles(self) -> int:
        return self.tr * self.tc

    @property
    def tile_shape(self) -> Tuple[int, int]:
        assert self.H % self.tr == 0 and self.W % self.tc == 0
        return self.H // self.tr, self.W // self.tc

    def neighbors(self, t: int) -> Dict[str, Optional[int]]:
        r, c = divmod(t, self.tc)
        return {
            "up": t - self.tc if r > 0 else None,
            "down": t + self.tc if r < self.tr - 1 else None,
            "left": t - 1 if c > 0 else None,
            "right": t + 1 if c < self.tc - 1 else None,
        }


def choose_tiling(n_tiles: int) -> Tuple[int, int]:
    """Near-square factorization."""
    best = (1, n_tiles)
    for a in range(1, int(n_tiles ** 0.5) + 1):
        if n_tiles % a == 0:
            best = (a, n_tiles // a)
    return best


# --------------------------------------------------------------- tile kernels
# ``jacobi_tile_step`` (imported above) is the 5-point update of tiles
# (..., h, w) given their halo rows and columns.


def lulesh_tile_step(tile, up, down, left, right, *, inner_iters: int = 8):
    """Compute-bound proxy (LULESH stand-in): same halo pattern, but each
    step runs ``inner_iters`` rounds of stencil + EOS-like transcendental
    pointwise work, making compute >> communication (paper §III-B).

    Plain torch ops, as the reference's is XLA-compiled jnp (it has no
    Pallas kernel).  The neighbour sum does not change across the inner
    rounds; it is computed once."""
    nsum = neighbour_sum(tile, up, down, left, right)
    x = tile
    for _ in range(inner_iters):
        lap = nsum - 4.0 * x
        # artificial EOS: e = e + dt * (p / (rho + eps)); p ~ e^gamma
        e = torch.abs(x) + 1e-6
        p = torch.exp(0.4 * torch.log(e))
        x = x + 1e-3 * lap + 1e-4 * (p / (e + 0.1) - 1.0)
    return x


def _prepare_lulesh(src, ids, nbr, out):
    def step():
        out[ids.long()] = lulesh_tile_step(*tile_halos(src, ids, nbr))
        return out
    return step


# One PE's step over its tiles, prepared: ``prepare(src, ids, nbr, out)``
# returns a function of no arguments that writes ``out[ids]``.  Jacobi is
# one launch of the stencil kernel on a card (its checks done before the
# call, so events around the call time the kernel).
PE_STEPS = {"jacobi": prepare_jacobi_tiles, "lulesh": _prepare_lulesh}


# --------------------------------------------------------------- the runtime
@dataclasses.dataclass
class CommModel:
    """Per-halo-message latency model (cloud TCP vs HPC fabric).

    cost = latency_s + bytes / bw.  Applied as *accounted* time (added to
    the measured step wall-time), so experiments can sweep network quality
    deterministically on one host.
    """
    latency_s: float = 0.0
    bw_Bps: float = float("inf")

    def cost(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.bw_Bps


def _to_device_ints(rows, device) -> torch.Tensor:
    """A host int list as an int32 tensor on ``device``; to a card through
    pinned memory without blocking, so that no step waits on the copy."""
    t = torch.tensor(rows, dtype=torch.int32)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class HostTileRuntime:
    """Charm++-style overdecomposed execution of a stencil app."""

    def __init__(self, grid: TileGrid, n_pes: int, *, kernel: str = "jacobi",
                 odf: Optional[int] = None, dtype=torch.float32,
                 pe_rate_multipliers: Optional[Sequence[float]] = None,
                 comm: Optional[CommModel] = None, device="cuda"):
        assert grid.n_tiles % n_pes == 0, (grid.n_tiles, n_pes)
        assert dtype in (torch.float32, torch.bfloat16), dtype
        self.device = resolve_device(device)
        self.grid = grid
        self.n_pes = n_pes
        self.odf = odf or grid.n_tiles // n_pes
        self.comm = comm or CommModel()
        h, w = grid.tile_shape
        self.dtype = dtype
        self.tiles = torch.zeros((grid.n_tiles, h, w), dtype=dtype,
                                 device=self.device)
        # boundary conditions: hot top edge (classic Laplace problem)
        self.tiles[:grid.tc, 0, :] = 1.0
        self._next = torch.empty_like(self.tiles)
        self.itemsize = self.tiles.element_size()
        # (up, down, left, right) of every tile, -1 at the boundary
        self.nbr = _to_device_ints(
            [[-1 if n is None else n for n in grid.neighbors(t).values()]
             for t in range(grid.n_tiles)], self.device)
        self.assignment = np.arange(grid.n_tiles) % n_pes  # block-cyclic home
        self.monitor = RateMonitor(n_pes)
        self._pe_mult = (np.asarray(pe_rate_multipliers, dtype=np.float64)
                         if pe_rate_multipliers is not None
                         else np.ones(n_pes))
        # one launch per PE per step: chare scheduling overhead stays
        # micro-seconds-scale, as in Charm++
        self._prepare = PE_STEPS[kernel]
        self._placed = None       # the assignment the id cache was built for
        self._objs: List[List[int]] = []
        self._ids: List[Optional[torch.Tensor]] = []
        self._events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        # tile counts whose first run is done, or None: nothing to warm
        self._warm = None if kernel == "jacobi" and \
            self.device.type == "cuda" else set()
        self.iteration = 0
        self.host_syncs = 0       # one per step on a card: the timing read
        self.last_pe_compute = np.zeros(n_pes)   # seconds, the last step

    # ----------------------------------------------------------- placement
    def _placement(self):
        """Per-PE tile ids (host lists and cached device tensors), rebuilt
        whenever the assignment differs from the one they were built for."""
        if self._placed is None or len(self._objs) != self.n_pes or \
                not np.array_equal(self._placed, self.assignment):
            self._placed = np.array(self.assignment, copy=True)
            self._objs = [[int(t) for t in np.nonzero(self._placed == pe)[0]]
                          for pe in range(self.n_pes)]
            self._ids = [_to_device_ints(o, self.device) if o else None
                         for o in self._objs]
        if self.device.type == "cuda" and len(self._events) != self.n_pes:
            self._events = [(torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
                            for _ in range(self.n_pes)]
        return self._objs, self._ids

    def pe_ids(self, pe: int) -> Optional[torch.Tensor]:
        """The int32 device ids of the tiles ``pe`` holds (None if none):
        what its launch computes."""
        return self._placement()[1][pe]

    def _comm_seconds(self, pe: int, objs) -> float:
        """Accounted halo communication time for one PE's tiles.

        Message latencies overlap each other (async sends, all in flight
        concurrently); bytes serialize on the NIC.  Remote edges only.
        """
        h, w = self.grid.tile_shape
        itemsize = self.itemsize
        total_bytes = 0
        n_remote = 0
        for t in objs:
            for side, n in self.grid.neighbors(t).items():
                if n is None or self.assignment[n] == pe:
                    continue  # on-PE neighbor: shared memory, free
                total_bytes += (w if side in ("up", "down") else h) * itemsize
                n_remote += 1
        if n_remote == 0:
            return 0.0
        return self.comm.latency_s + total_bytes / self.comm.bw_Bps

    # ----------------------------------------------------------- step
    def step(self) -> Dict[str, float]:
        """One iteration; returns measured per-PE seconds (incl. accounted
        heterogeneity multipliers + comm model)."""
        pe_compute = np.zeros(self.n_pes)
        pe_comm = np.zeros(self.n_pes)
        pe_ntiles = np.zeros(self.n_pes)
        objs_by_pe, ids_by_pe = self._placement()
        on_card = self.device.type == "cuda"
        # The first launch after the last step's sync finds the card idle,
        # and its events also time the launch's latency (about 12 us, 5%
        # of a launch over four 4096^2 tiles, on an NVIDIA H100 80GB HBM3
        # at 700 W; chip_smoke.py).  The PE that goes first rotates, so
        # that every PE pays it as often and equal work measures equal.
        first = self.iteration % self.n_pes
        order = [(first + k) % self.n_pes for k in range(self.n_pes)]
        last = None
        for pe in order:
            objs, ids = objs_by_pe[pe], ids_by_pe[pe]
            if not objs:
                continue
            last = pe
            pe_ntiles[pe] = len(objs)
            run = self._prepare(self.tiles, ids, self.nbr, self._next)
            if self._warm is not None and len(objs) not in self._warm:
                run()                 # untimed first run at this count
                self._warm.add(len(objs))
            if on_card:
                start, end = self._events[pe]
                start.record()
                run()
                end.record()
            else:
                t0 = time.perf_counter()
                run()
                pe_compute[pe] = time.perf_counter() - t0
            pe_comm[pe] = self._comm_seconds(pe, objs)
        if on_card:
            # the step's one host sync: every PE's launch has ended once
            # the last recorded event has
            self._events[last][1].synchronize()
            self.host_syncs += 1
            for pe in range(self.n_pes):
                if objs_by_pe[pe]:
                    start, end = self._events[pe]
                    pe_compute[pe] = start.elapsed_time(end) / 1e3
        self.last_pe_compute = pe_compute     # measured, before multipliers
        pe_compute = pe_compute / self._pe_mult
        self.tiles, self._next = self._next, self.tiles
        self.iteration += 1
        # Overdecomposition overlap (Fig 1): while one tile's halos are in
        # flight the PE computes its other tiles.  A single tile per PE
        # cannot overlap anything; with k tiles, (k-1)/k of the compute is
        # available to hide the comm window.
        overlappable = pe_compute * np.maximum(pe_ntiles - 1, 0) \
            / np.maximum(pe_ntiles, 1)
        exposed = np.maximum(pe_comm - overlappable, 0.0)
        pe_seconds = pe_compute + exposed
        # Accounted time: the same model, but per-PE compute rebuilt from
        # this iteration's *fastest measured per-tile cost* scaled by tile
        # count and the PE's rate multiplier.  Tile placement, modeled
        # heterogeneity, and modeled comm all still move it; OS scheduling
        # jitter on a contended host does not — assertions about LB and
        # overlap effects compare this, not raw wall-clock.  The rate
        # monitor keeps consuming the MEASURED seconds: a genuinely slow
        # PE (no declared multiplier) must still show up as a straggler
        # to the load balancer.
        active = pe_ntiles > 0
        unit = float((pe_compute[active] * self._pe_mult[active]
                      / pe_ntiles[active]).min()) if active.any() else 0.0
        acc_compute = np.where(active,
                               unit * pe_ntiles / self._pe_mult, 0.0)
        acc_overlappable = acc_compute * np.maximum(pe_ntiles - 1, 0) \
            / np.maximum(pe_ntiles, 1)
        acc_exposed = np.maximum(pe_comm - acc_overlappable, 0.0)
        acc_seconds = acc_compute + acc_exposed
        self.monitor.record_step(
            per_pe_work=[float((self.assignment == pe).sum())
                         for pe in range(self.n_pes)],
            per_pe_seconds=pe_seconds)
        return {
            "time_per_iter": float(pe_seconds.max()),
            "accounted_time_per_iter": float(acc_seconds.max()),
            "compute_max": float(pe_compute.max()),
            "comm_exposed_max": float(exposed.max()),
        }

    # ----------------------------------------------------------- LB hooks
    def load_balance(self, strategy: str = "greedy_refine",
                     rate_aware: bool = True) -> lb.LBResult:
        loads = np.ones(self.grid.n_tiles)   # uniform tiles (paper's apps)
        rates = self.monitor.rates() if rate_aware else None
        res = lb.balance(strategy, loads, self.n_pes, rates=rates,
                         current=self.assignment)
        self.assignment = res.assignment
        return res

    # ----------------------------------------------------------- elasticity
    def checkpoint(self):
        """The migratable-object state: tiles + assignment + iteration, the
        tiles as host numpy (float32 for bf16 tiles)."""
        host = self.tiles.cpu().float().numpy()
        return {
            "tiles": {t: host[t].copy() for t in range(self.grid.n_tiles)},
            "assignment": self.assignment.copy(),
            "iteration": self.iteration,
        }

    def restore(self, snap, n_pes: Optional[int] = None):
        n_pes = n_pes or self.n_pes
        host = np.stack([np.asarray(snap["tiles"][t], dtype=np.float32)
                         for t in range(self.grid.n_tiles)])
        self.tiles = torch.from_numpy(host).to(self.device, self.dtype)
        self._next = torch.empty_like(self.tiles)
        self.iteration = snap["iteration"]
        self.n_pes = n_pes
        self.monitor.resize(n_pes)
        if len(self._pe_mult) != n_pes:
            self._pe_mult = np.ones(n_pes)
        # remap objects onto the new PE set, then LB
        self.assignment = snap["assignment"] % n_pes
        self.odf = self.grid.n_tiles // n_pes
        self._placed = None

    def device_grid(self) -> torch.Tensor:
        """The global ``(H, W)`` grid, on the device, in the tiles' dtype."""
        h, w = self.grid.tile_shape
        g = self.grid
        return self.tiles.view(g.tr, g.tc, h, w).permute(0, 2, 1, 3) \
            .reshape(g.H, g.W)

    def global_grid(self) -> np.ndarray:
        return self.device_grid().cpu().to(torch.float64).numpy()


# ------------------------------------------------------------ event driver
class TileRuntimeDriver:
    """Event-driven stencil execution on the shared ``EventLoop``.

    Replaces host-side ``for it in range(iters)`` driving: iterations are
    ``tile_step`` events at a virtual cadence, load balancing fires as its
    own periodic events, and a bound :class:`FaultTrace` triggers the §IV
    responses — a proactive rebalance at the *recommendation* and an
    application checkpoint at the *interruption notice* — at exactly the
    trace's timestamps, so a stencil app and a serving cluster handed the
    same trace replay the identical fault schedule.
    """

    _ids = itertools.count()

    def __init__(self, rt: HostTileRuntime, loop: EventLoop, *,
                 iters: int, step_interval: float = 1.0,
                 lb_interval: float = 0.0,
                 lb_strategy: str = "greedy_refine", rate_aware: bool = True,
                 trace: Optional[FaultTrace] = None, t0: float = 0.0):
        self.rt = rt
        self.loop = loop
        self.iters = iters
        self.step_interval = step_interval
        self.lb_interval = lb_interval
        self.lb_strategy = lb_strategy
        self.rate_aware = rate_aware
        self.per_iter: List[Dict[str, float]] = []
        self.timeline: List[Tuple[float, str]] = []
        self.checkpoints: List[Tuple[float, dict]] = []
        n = next(self._ids)
        self._step_kind = f"tile_step_{n}"
        self._lb_kind = f"tile_lb_{n}"
        self._fault_kind = f"tile_fault_{n}"
        loop.register(self._step_kind, self._on_step)
        loop.schedule(t0 + step_interval, self._step_kind)
        if lb_interval > 0:
            loop.register(self._lb_kind, self._on_lb)
            loop.schedule(t0 + lb_interval, self._lb_kind)
        if trace is not None:
            loop.register(self._fault_kind, self._on_fault)
            trace.bind(loop, kind=self._fault_kind)

    @property
    def done(self) -> bool:
        return self.rt.iteration >= self.iters

    def _on_step(self, ev, t: float):
        if self.done:
            return
        self.per_iter.append(self.rt.step())
        if not self.done:
            self.loop.schedule(t + self.step_interval, self._step_kind)

    def _on_lb(self, ev, t: float):
        if self.done:
            return
        res = self.rt.load_balance(self.lb_strategy,
                                   rate_aware=self.rate_aware)
        self.timeline.append((t, f"lb migrations={res.migrations}"))
        self.loop.schedule(t + self.lb_interval, self._lb_kind)

    def _on_fault(self, ev, t: float):
        notice = ev.payload["notice"]
        self.timeline.append((t, f"{notice.kind} target={notice.target}"))
        if self.done:
            return
        if notice.kind == "rebalance_recommendation":
            # proactive: rebalance off the doomed capacity ahead of the
            # notice (paper Mode C applied to the stencil app)
            res = self.rt.load_balance(self.lb_strategy,
                                       rate_aware=self.rate_aware)
            self.timeline.append((t, f"lb migrations={res.migrations}"))
        elif notice.kind == "interruption_notice":
            self.checkpoints.append((t, self.rt.checkpoint()))
