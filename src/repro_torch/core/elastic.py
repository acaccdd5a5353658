"""Elastic runtime: shrink / expand via checkpoint + restart (§II-B).

Port of ``repro.core.elastic``.  Charm++'s rescaling protocol, step for
step:

  1. migrate work away from departing PEs   (the state moves whole)
  2. checkpoint                             -> ``store.save`` (host RAM,
                                               a device copy or a file)
  3. restart with the new PE count          -> a new device list and a
                                               new step function
  4. restore state                          -> ``store.restore`` onto the
                                               new list's first device
  5. load balance                           -> a synchronize on the
                                               restored state's device

Each rescale records the paper's four timed stages (checkpoint / load
balance / restart / restore, Figures 5-6).  A stage that copies on the
card ends with a synchronize (the stores do it), so its time covers the
copies.  "Restart" has no compile to redo: eager PyTorch has no AOT
step, so the stage is the rebuild of the device list and the step
function, and is small beside the reference's re-jit.

One device only: ``devices_for(n)`` is the first ``n`` devices of the
runtime's device type, and ``n > 1`` (or more than are present) raises:
data parallelism over ``torch.distributed`` is ROADMAP item 13.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import torch

from repro_torch.core.checkpointing import InMemoryStore, tree_map
from repro_torch.device import resolve_device


@dataclasses.dataclass
class RescaleEvent:
    kind: str                 # 'shrink' | 'expand'
    from_devices: int
    to_devices: int
    stages: Dict[str, float]  # checkpoint/loadbalance/restart/restore seconds

    @property
    def total(self) -> float:
        return sum(self.stages.values())


def devices_for(n: int, device="cuda") -> List[torch.device]:
    """The first ``n`` devices of ``device``'s type.  One is all the port
    runs: ``n > 1`` raises (ROADMAP item 13), whatever is present."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"{n} devices asked for")
    if n > 1:
        present = torch.cuda.device_count() if dev.type == "cuda" else 1
        raise NotImplementedError(
            f"{n} {dev.type} devices asked for ({present} present): the "
            f"port trains on one device; data parallelism over "
            f"torch.distributed is ROADMAP item 13")
    return [dev]


class ElasticRuntime:
    """Owns the device list (``mesh``: ``devices_for(n)``), the step
    function and the state, and runs the five-step rescale protocol
    (``rescale_to``).  ``step_factory(devices)`` returns ``fn(state,
    batch) -> (state, out)``; the state lives on ``devices[0]``.
    """

    def __init__(self, *, step_factory: Callable, init_state,
                 n_devices: int, store=None, device="cuda"):
        self.device_type = resolve_device(device).type
        self.step_factory = step_factory
        self.store = store or InMemoryStore()
        self.events: List[RescaleEvent] = []
        self.n_devices = n_devices
        self.mesh = devices_for(n_devices, self.device_type)
        self._step = step_factory(self.mesh)
        self.state = tree_map(lambda t: t.to(self.mesh[0]), init_state)

    def step(self, batch):
        self.state, out = self._step(self.state, batch)
        return out

    def rescale_to(self, n_devices: int) -> RescaleEvent:
        kind = "shrink" if n_devices < self.n_devices else "expand"
        stages: Dict[str, float] = {}

        t0 = time.perf_counter()
        self.store.save("elastic", self.state)
        stages["checkpoint"] = time.perf_counter() - t0
        self.state = None             # the departing devices' copy

        # "restart": drop the old step function, rebuild the device list
        # and the step function for it
        t0 = time.perf_counter()
        del self._step
        self.mesh = devices_for(n_devices, self.device_type)
        self._step = self.step_factory(self.mesh)
        stages["restart"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.state = self.store.restore("elastic", device=self.mesh[0])
        stages["restore"] = time.perf_counter() - t0

        # post-expand LB step (§II-B): one device holds the whole state,
        # so the pass is the wait for it, as the reference's
        # block_until_ready
        t0 = time.perf_counter()
        if self.mesh[0].type == "cuda":
            torch.cuda.synchronize(self.mesh[0])
        stages["loadbalance"] = time.perf_counter() - t0

        ev = RescaleEvent(kind, self.n_devices, n_devices, stages)
        self.n_devices = n_devices
        self.events.append(ev)
        return ev

