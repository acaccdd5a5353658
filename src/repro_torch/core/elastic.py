"""Elastic runtime: shrink / expand via checkpoint + restart (§II-B).

Port of ``repro.core.elastic``.  Charm++'s rescaling protocol, step for
step:

  1. migrate work away from departing PEs   (the state moves whole)
  2. checkpoint                             -> gather the state whole
                                               (ZeRO-1 blocks included),
                                               ``store.save`` on rank 0
  3. restart with the new PE count          -> a new mesh of the first
                                               ``n`` ranks (or device
                                               list) and step function
  4. restore state                          -> ``store.restore`` on rank
                                               0, a broadcast to the new
                                               members, each keeping its
                                               blocks (``place``)
  5. load balance                           -> a barrier over the world
                                               and a synchronize

Each rescale records the paper's four timed stages (checkpoint / load
balance / restart / restore, Figures 5-6).  A stage that copies on the
card ends with a synchronize (the stores do it), so its time covers the
copies.  "Restart" has no compile to redo: eager PyTorch has no AOT
step, so the stage is the rebuild of the mesh (its process groups) and
the step function, and is small beside the reference's re-jit.

Two settings, chosen by whether a ``torch.distributed`` process group is
initialised:

* none: one device, ``devices_for(1)`` is ``[device]`` and more raises;
* a group (``launch.dist``): ``devices_for(n, model_par)`` is the
  ``DeviceMesh`` of the first ``n`` ranks of the world
  (``launch.mesh.make_mesh((n // model_par, model_par), ("data",
  "model"))``, the reference's ``_mesh_for``).  Ranks outside it hold no
  state and skip steps.
  Every rank of the world calls ``step``, ``rescale_to`` and the
  constructor, so that the program stays SPMD: building a mesh is a
  collective over the world.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

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


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def devices_for(n: int, device="cuda", model_par: int = 1):
    """Without a process group: ``[device]`` for ``n == 1`` (and
    ``model_par == 1``), and more raises.  With one: the ``("data",
    "model")`` ``DeviceMesh`` of shape ``(n // model_par, model_par)``
    over the first ``n`` ranks (every rank of the world must call this;
    a rank outside the mesh gets it with ``get_coordinate() is None``)."""
    dev = resolve_device(device)
    if n < 1 or model_par < 1:
        raise ValueError(f"{n} devices asked for, in model groups of "
                         f"{model_par}")
    if distributed():
        if n % model_par:
            raise ValueError(f"{n} devices do not split into model groups "
                             f"of {model_par}")
        from repro_torch.launch.mesh import make_mesh
        return make_mesh((n // model_par, model_par), ("data", "model"),
                         device=dev)
    if n > 1 or model_par > 1:
        raise RuntimeError(
            f"{n} devices (model axis {model_par}) asked for without a "
            f"torch.distributed process group: start the ranks (python -m "
            f"repro_torch.launch.train --n-devices N, torchrun, or "
            f"launch.dist.process_group) and build the runtime in each")
    return [dev]


class ElasticRuntime:
    """Owns the mesh (``devices_for(n)``), the step function and the
    state, and runs the five-step rescale protocol (``rescale_to``).

    ``step_factory(mesh)`` returns ``fn(state, batch) -> (state, out)``.
    ``shardings_factory(mesh)`` (the reference's name) returns the
    state's layout on a ``DeviceMesh``, an object with ``place(whole) ->
    local`` and ``gather_state(local) -> whole`` (``model_zoo.
    DataParallel``); without it the state is whole on every member.
    ``init_state`` is the whole state, the same on every rank.
    ``model_par`` is the mesh's model axis, kept across rescales.
    """

    def __init__(self, *, step_factory: Callable, init_state,
                 n_devices: int, store=None, device="cuda",
                 shardings_factory: Optional[Callable] = None,
                 model_par: int = 1):
        self.model_par = model_par
        self.device = resolve_device(device)
        self.device_type = self.device.type
        self.step_factory = step_factory
        self.shardings_factory = shardings_factory
        self.store = store or InMemoryStore()
        self.events: List[RescaleEvent] = []
        self.n_devices = n_devices
        # shapes and dtypes of the whole state: a new member's buffers
        self._skeleton = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            init_state)
        self._restart(n_devices)
        self.state = (self._place(tree_map(lambda t: t.to(self.device),
                                           init_state))
                      if self.member else None)

    # ------------------------------------------------------------ layout
    @property
    def member(self) -> bool:
        """Whether this process holds a share of the mesh's work."""
        return (isinstance(self.mesh, list)
                or self.mesh.get_coordinate() is not None)

    def _restart(self, n_devices: int):
        self.mesh = devices_for(n_devices, self.device,
                                self.model_par)
        member = self.member
        if isinstance(self.mesh, list):       # one device, no group
            self.device, self.layout = self.mesh[0], None
        else:
            self.layout = (self.shardings_factory(self.mesh)
                           if member and self.shardings_factory else None)
        self._step = self.step_factory(self.mesh) if member else None

    def _place(self, whole):
        return self.layout.place(whole) if self.layout else whole

    def gathered_state(self):
        """The whole state on every member (a collective over the mesh:
        every member calls it); ``None`` elsewhere."""
        if not self.member:
            return None
        return (self.layout.gather_state(self.state) if self.layout
                else self.state)

    def _broadcast_whole(self, whole):
        """Rank 0's whole state (``whole``; ``None`` on the other
        members) to every member of the current mesh: over the data
        group of model coordinate 0, then over each model group from
        its coordinate-0 rank."""
        if whole is None:
            whole = tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device=self.device), self._skeleton)
        d, m = self.mesh.get_coordinate()
        if m == 0 and self.mesh.shape[0] > 1:
            group = self.mesh.get_group("data")
            tree_map(lambda t: dist.broadcast(t, src=0, group=group), whole)
        if self.mesh.shape[1] > 1:
            group = self.mesh.get_group("model")
            src = int(self.mesh.mesh[d, 0])
            tree_map(lambda t: dist.broadcast(t, src=src, group=group), whole)
        return whole

    # ------------------------------------------------------------ protocol
    def step(self, batch):
        """One step on the members; ``None`` on a rank outside the mesh."""
        if not self.member:
            return None
        self.state, out = self._step(self.state, batch)
        return out

    def rescale_to(self, n_devices: int) -> RescaleEvent:
        kind = "shrink" if n_devices < self.n_devices else "expand"
        stages: Dict[str, float] = {}
        on_world = distributed()
        rank = dist.get_rank() if on_world else 0

        t0 = time.perf_counter()
        whole = self.gathered_state()
        if rank == 0:
            self.store.save("elastic", whole)
        stages["checkpoint"] = time.perf_counter() - t0
        self.state = whole = None     # the departing devices' copy

        # "restart": drop the old step function, rebuild the mesh (its
        # process groups) and the step function for it
        t0 = time.perf_counter()
        del self._step
        self._restart(n_devices)
        stages["restart"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if rank == 0:
            whole = self.store.restore("elastic", device=self.device)
        if on_world and self.member and self.mesh.size() > 1:
            whole = self._broadcast_whole(whole)
        if self.member:
            self.state = self._place(whole)
        stages["restore"] = time.perf_counter() - t0

        # post-expand LB step (§II-B): every member holds its share, so
        # the pass is the wait for all of them, as the reference's
        # block_until_ready
        t0 = time.perf_counter()
        if on_world:
            dist.barrier()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stages["loadbalance"] = time.perf_counter() - t0

        ev = RescaleEvent(kind, self.n_devices, n_devices, stages)
        self.n_devices = n_devices
        self.events.append(ev)
        return ev
