"""CloudManager — proactive spot-instance management (paper §IV, Fig 4).

A deterministic discrete-event simulation of an EC2-style fleet (spot pools,
rebalance recommendations, 2-minute interruption notices, replacement launch
latency) driving an elastic application.  Interruptions can be injected
explicitly (the AWS Fault-Injection-Simulator analogue used in the paper's
experiments) or sampled.

Interruption-handling modes (§IV-C):

* ``Mode.A_FILESYSTEM`` — checkpoint to a shared filesystem on the notice;
  the app restarts from disk once capacity is back (3 stages: checkpoint /
  restart / restore; both ends scale with fleet size).
* ``Mode.B_REACTIVE``   — Bhosale et al. [6]: in-memory checkpoint; shrink
  before the deadline, then a second rescale (expand) when the replacement
  eventually launches.  Two full rescale cycles.
* ``Mode.C_PROACTIVE``  — this paper: capacity rebalancing.  Replacements are
  requested at the *rebalance recommendation*; the rescale is deferred until
  one of three trigger conditions (complete / emergency / T_timeout), so a
  single rescale swaps doomed instances for ready replacements.

Stage costs come from a ``StageCostModel``: seconds per checkpoint,
restore, restart and load-balance stage as a function of fleet size.

Event plumbing lives in ``repro_torch.runtime``: the manager registers
named handlers on a shared :class:`~repro_torch.runtime.EventLoop` and
consumes its interruption schedule from a
:class:`~repro_torch.runtime.FaultTrace`, so a
serving cluster handed the *same* trace observes the identical
rebalance/notice/terminate timestamps.

Port of ``repro.core.cloud``, host code over ``repro_torch.runtime``.
``StageCostModel``'s default bandwidths and restart seconds are the
reference simulation's constants, copied so that seeded runs match; they
were not measured on any GPU.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime import (EventLoop, FaultTrace, SpotEventFeed,
                                 SpotNotice)

__all__ = ["Mode", "Instance", "StageCostModel", "SpotEventFeed",
           "SpotNotice", "RunReport", "CloudManager"]


class Mode(enum.Enum):
    A_FILESYSTEM = "A"
    B_REACTIVE = "B"
    C_PROACTIVE = "C"


# ------------------------------------------------------------------ fleet
@dataclasses.dataclass
class Instance:
    iid: int
    itype: str
    is_spot: bool = True
    state: str = "running"      # running | at_risk | doomed | terminated
    launched_at: float = 0.0


@dataclasses.dataclass
class StageCostModel:
    """Seconds per rescale stage as a function of fleet size n.

    Fitted from real measurements: checkpoint/restore scale with per-instance
    bytes (total/n for in-memory; total and shared-bandwidth-limited for
    filesystem), restart grows ~log(n) (startup), LB ~ bytes moved.
    """
    state_bytes: float                     # application state size
    host_bw: float = 8e9                   # host-RAM copy bytes/s ("shm")
    device_bw: float = 400e9               # on-device copy bytes/s (daemon)
    fs_bw: float = 0.35e9                  # shared-FS bytes/s (EFS elastic)
    restart_base: float = 4.0              # app startup, 1 instance
    restart_log: float = 1.2               # + log2(n) growth (paper Fig 5)
    restart_accel_extra: float = 9.0       # CUDA-init analogue (paper Fig 6)
    lb_frac: float = 0.3                   # fraction of state migrated by LB
    accelerator: bool = False

    def checkpoint(self, n: int, store: str) -> float:
        per_inst = self.state_bytes / max(n, 1)
        bw = {"memory": self.host_bw, "device": self.device_bw,
              "filesystem": self.fs_bw}[store]
        if store == "filesystem":
            # shared FS: aggregate bandwidth, grows with total size
            return self.state_bytes / bw / max(math.sqrt(n), 1.0)
        return per_inst / bw

    restore = checkpoint

    def restart(self, n: int) -> float:
        extra = self.restart_accel_extra if self.accelerator else 0.0
        return self.restart_base + extra + self.restart_log * math.log2(
            max(n, 2))

    def loadbalance(self, n: int, moved_frac: Optional[float] = None) -> float:
        frac = self.lb_frac if moved_frac is None else moved_frac
        bw = self.device_bw if self.accelerator else self.host_bw
        # migrating GPU-resident data without RDMA goes via host staging
        if self.accelerator:
            bw = self.host_bw * 2  # staged copies overlap both directions
        return frac * self.state_bytes / max(n, 1) / bw

    def rescale(self, n: int, store: str,
                lb_frac: Optional[float] = None) -> Dict[str, float]:
        return {
            "checkpoint": self.checkpoint(n, store),
            "loadbalance": 0.0 if store == "filesystem"
            else self.loadbalance(n, lb_frac),
            "restart": self.restart(n),
            "restore": self.restore(n, store),
        }


# ------------------------------------------------------------------ manager
@dataclasses.dataclass
class RunReport:
    total_time: float
    ideal_time: float
    rescales: List[Dict[str, float]]
    interruption_overhead: float
    timeline: List[Tuple[float, str]]

    @property
    def overhead_frac(self) -> float:
        return self.total_time / self.ideal_time - 1.0


class CloudManager:
    """Monitoring task + replacement policy + rescale triggers (Fig 4).

    The manager owns no event heap: it registers handlers on a
    ``repro_torch.runtime.EventLoop`` and receives the spot lifecycle from a
    ``FaultTrace`` (its own by default; pass ``trace=`` to share one
    schedule with other subsystems, e.g. a serving cluster).
    """

    def __init__(self, *, n_instances: int, mode: Mode,
                 cost: StageCostModel,
                 t_timeout: float = 120.0,
                 replacement_latency: float = 90.0,
                 notice_deadline: float = 120.0,
                 rebalance_lead: float = 180.0,
                 iter_seconds: float = 1.0,
                 total_iters: int = 5000,
                 seed: int = 0,
                 trace: Optional[FaultTrace] = None):
        self.mode = mode
        self.cost = cost
        self.t_timeout = t_timeout
        self.replacement_latency = replacement_latency
        self.trace = trace if trace is not None else FaultTrace(
            rebalance_lead=rebalance_lead, notice_deadline=notice_deadline)
        self.notice_deadline = self.trace.notice_deadline
        self.rebalance_lead = self.trace.rebalance_lead
        self.iter_seconds = iter_seconds
        self.total_iters = total_iters
        self.target = n_instances
        self.rng = np.random.default_rng(seed)

        self._ids = itertools.count()
        self.fleet: Dict[int, Instance] = {
            (i := next(self._ids)): Instance(i, "spot.xlarge")
            for _ in range(n_instances)
        }
        self.loop = EventLoop()
        self.loop.register("spot", self._on_spot)
        self.loop.register("replacement", self._on_replacement)
        self.loop.register("timeout", self._on_timeout)
        self.trace.bind(self.loop, kind="spot")
        # lifecycle id -> victim iid: keyed per interruption, not per
        # target, because a sampled trace cycles target ids and the same
        # target can have overlapping lifecycles in flight
        self._victim_of: Dict[int, int] = {}
        self._fis_targets = itertools.count(10_000)
        self._oldest_rebalance: Optional[float] = None
        self._pending_replacements = 0
        self.timeline: List[Tuple[float, str]] = []
        self.rescales: List[Dict[str, float]] = []

    # ------------------------------------------------------------ events
    def inject_interruption(self, t: float, count: int = 1):
        """FIS analogue: at virtual time t, ``count`` running spot instances
        get a rebalance recommendation, followed by the 2-minute notice."""
        for _ in range(count):
            self.trace.inject(t, next(self._fis_targets))

    # ------------------------------------------------------------ dynamics
    def _running(self) -> List[Instance]:
        return [i for i in self.fleet.values() if i.state != "terminated"]

    def _at_risk(self) -> List[Instance]:
        return [i for i in self.fleet.values()
                if i.state in ("at_risk", "doomed")]

    def run(self) -> RunReport:
        """Simulate until the application completes ``total_iters``."""
        t = self.loop.now()
        work_done = 0.0
        work_total = float(self.total_iters)
        ideal = self.total_iters * self.iter_seconds
        stalled_until = 0.0
        overhead = 0.0

        def capacity() -> float:
            if self._down:  # Mode A: a terminated rank kills the whole job
                return 0.0
            n_up = len([i for i in self.fleet.values()
                        if i.state in ("running", "at_risk", "doomed")])
            return min(n_up, self.target) / self.target

        while work_done < work_total:
            # next event or completion, whichever first
            rate = capacity() / self.iter_seconds  # iters per second
            if stalled_until > t:
                t_free = stalled_until
            else:
                t_free = t
            if rate > 0:
                t_done = t_free + (work_total - work_done) / rate
            else:
                t_done = math.inf
            t_next = self.loop.peek_t()
            if t_done <= t_next:
                work_done = work_total
                t = t_done
                break
            # progress until the event, then dispatch its handler
            prog_start = max(t, stalled_until)
            if t_next > prog_start and rate > 0:
                work_done += (t_next - prog_start) * rate
            t = t_next
            self.loop.dispatch_next()
            # handlers may stall the app (rescale downtime)
            if self._stall_pending:
                stalled_until = max(stalled_until, t) + self._stall_pending
                overhead += self._stall_pending
                self._stall_pending = 0.0
            if self._mark_request:       # checkpoint: remember progress
                self._work_mark = work_done
                self._mark_request = False
            if self._rollback_request:   # rank death: lose work since ckpt
                work_done = min(work_done, self._work_mark)
                self._rollback_request = False

        return RunReport(
            total_time=t,
            ideal_time=ideal,
            rescales=self.rescales,
            interruption_overhead=overhead,
            timeline=self.timeline,
        )

    _stall_pending: float = 0.0
    _down: bool = False
    _mark_request: bool = False
    _rollback_request: bool = False
    _work_mark: float = 0.0

    def _stall(self, seconds: float):
        self._stall_pending += seconds

    def _log(self, t: float, msg: str):
        self.timeline.append((t, msg))

    # ------------------------------------------------------------ handlers
    def _on_spot(self, ev, t: float):
        """One §IV lifecycle event from the shared ``FaultTrace``."""
        notice: SpotNotice = ev.payload["notice"]
        if notice.kind == "rebalance_recommendation":
            victims = [i for i in self._running() if i.state == "running"]
            if not victims:
                return
            v = victims[0]
            self._victim_of[notice.lifecycle] = v.iid
            v.state = "at_risk"
            self._log(t, f"rebalance_recommendation i{v.iid}")
            if self._oldest_rebalance is None:
                self._oldest_rebalance = t
                if self.mode == Mode.C_PROACTIVE:
                    self.loop.schedule(t + self.t_timeout, "timeout",
                                       started=t)
            if self.mode == Mode.C_PROACTIVE:
                # proactively request a replacement from the pools
                self._pending_replacements += 1
                self.loop.schedule(t + self.replacement_latency,
                                   "replacement")
            return

        inst = self.fleet.get(self._victim_of.get(notice.lifecycle, -1))
        if inst is None or inst.state == "terminated":
            return

        if notice.kind == "interruption_notice":
            inst.state = "doomed"
            self._log(t, f"interruption_notice i{inst.iid}")
            if self.mode == Mode.C_PROACTIVE:
                # emergency override: rescale NOW with whatever is ready
                self._trigger_rescale(t, reason="emergency")
            elif self.mode == Mode.B_REACTIVE:
                # reactive shrink before the deadline + request replacement
                self._do_rescale(t, reason="shrink", store="memory",
                                 drop_doomed=True)
                self._pending_replacements += 1
                self.loop.schedule(t + self.replacement_latency,
                                   "replacement")
            else:  # Mode A: checkpoint to FS; app dies with the instance
                n = len(self._running())
                ck = self.cost.checkpoint(n, "filesystem")
                self._stall(ck)
                self._mark_request = True
                self._log(t, f"fs_checkpoint {ck:.1f}s")
                self._pending_replacements += 1
                self.loop.schedule(t + self.replacement_latency,
                                   "replacement")
            return

        if notice.kind == "terminate":
            inst.state = "terminated"
            self._log(t, f"terminated i{inst.iid}")
            if self.mode == Mode.A_FILESYSTEM:
                # rigid ranks: the whole job is down until fs_restart,
                # and loses all work since the last checkpoint
                self._down = True
                self._rollback_request = True
                self._log(t, "job_down (rigid MPI-style ranks)")
                self._maybe_fs_restart(t)
            return

        raise ValueError(notice.kind)

    def _on_replacement(self, ev, t: float):
        self._pending_replacements -= 1
        i = next(self._ids)
        self.fleet[i] = Instance(i, "spot.xlarge", launched_at=t)
        self.fleet[i].state = "spare" if self.mode == Mode.C_PROACTIVE \
            else "running"
        self._log(t, f"replacement_launched i{i}")
        if self.mode == Mode.C_PROACTIVE:
            # complete-replacement trigger
            n_spare = len([x for x in self.fleet.values()
                           if x.state == "spare"])
            if n_spare >= len(self._at_risk()) and self._at_risk():
                self._trigger_rescale(t, reason="complete")
        elif self.mode == Mode.B_REACTIVE:
            self._do_rescale(t, reason="expand", store="memory")
        else:  # Mode A: new rank available; restart when whole
            self._maybe_fs_restart(t)

    def _on_timeout(self, ev, t: float):
        if (self._oldest_rebalance is not None
                and ev.payload["started"] == self._oldest_rebalance
                and self._at_risk()):
            self._trigger_rescale(t, reason="timeout")

    def _maybe_fs_restart(self, t: float):
        """Mode A restart: needs all doomed ranks dead and full capacity."""
        if not self._down:
            return
        doomed_alive = any(i.state == "doomed" for i in self.fleet.values())
        n = len([x for x in self.fleet.values()
                 if x.state in ("running", "spare")])
        if doomed_alive or n < self.target:
            return
        for x in self.fleet.values():
            if x.state == "spare":
                x.state = "running"
        stages = {
            "restart": self.cost.restart(n),
            "restore": self.cost.restore(n, "filesystem"),
        }
        self.rescales.append(dict(stages, reason="fs_restart", t=t, n=n))
        self._stall(sum(stages.values()))
        self._down = False
        self._log(t, "fs_restart")

    # ------------------------------------------------------------ rescale
    def _trigger_rescale(self, t: float, reason: str):
        """Mode C single-rescale: swap doomed/at-risk for ready spares."""
        spares = [i for i in self.fleet.values() if i.state == "spare"]
        at_risk = self._at_risk()
        # replace as many as we have spares for; leftover at-risk keep running
        for v, s in zip(at_risk, spares):
            v.state = "terminated"
            s.state = "running"
        for v in at_risk[len(spares):]:
            if v.state == "at_risk":
                v.state = "running"   # not replaced; keeps running for now
        self._oldest_rebalance = None
        self._do_rescale(t, reason=f"proactive_{reason}", store="memory",
                         single=True)

    def _do_rescale(self, t: float, reason: str, store: str,
                    drop_doomed: bool = False, single: bool = False):
        if drop_doomed:
            for v in list(self.fleet.values()):
                if v.state == "doomed":
                    v.state = "terminated"
        n = len([i for i in self.fleet.values()
                 if i.state in ("running", "at_risk")])
        stages = self.cost.rescale(max(n, 1), store)
        self.rescales.append(dict(stages, reason=reason, t=t, n=n))
        self._stall(sum(stages.values()))
        self._log(t, f"rescale[{reason}] n={n} "
                     f"total={sum(stages.values()):.1f}s")
