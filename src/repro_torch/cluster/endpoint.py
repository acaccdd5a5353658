"""MigrationEndpoint: store-backed staging for WorkUnit payloads.

Every migration (drain, rebalance, preempt) round-trips the packed
unit's cache columns through a checkpoint store, so the §IV
checkpoint/restore stages are actually exercised and *timed* — not
assumed.  The endpoint abstracts WHICH store:

* ``HostEndpoint``   — ``InMemoryStore`` (the Linux-shared-memory
                       substrate of §II-B): payloads stage through host
                       RAM.  The default for plain instances.
* ``DeviceEndpoint`` — ``DeviceStore`` (the GPU daemon-process analogue
                       of §IV-A): payloads stage through a second
                       device-resident buffer, so an accelerator host's
                       drain pays an HBM-to-HBM round trip instead of
                       crossing the host link.

Replicas pick their endpoint from ``InstanceType.accelerator`` (or an
explicit override); the measured per-stage seconds flow into
``DrainRecord``/cluster metrics either way, so the host-vs-device cost
asymmetry the paper measures (Fig 5 vs 6) shows up in serving drains
too.

Port of ``repro.cluster.endpoint``.  The payloads are the port's
snapshot columns (CPU tensors, pinned when packed from the card), and
the restored tensors go back into the units as they are: numpy holds
no bf16 without ``ml_dtypes``.  Each endpoint takes the ``device`` of
its replica.  ``HostEndpoint`` restores onto the host (unpinned CPU
copies, which the target engine's install copies to the card);
``DeviceEndpoint`` keeps its copy on the replica's device and restores
it there, so the target's install is a device-to-device copy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core.checkpointing import DeviceStore, InMemoryStore
from repro_torch.device import resolve_device
from repro_torch.serving.workunit import (RESIDENCY_DEVICE, RESIDENCY_HOST,
                                          WorkUnit)


class EndpointUnavailable(RuntimeError):
    """Transient staging-store failure (armed by an ``endpoint_failure``
    chaos fault); staging ops retry with exponential backoff."""


class MigrationEndpoint:
    """Round-trips packed payloads through a checkpoint store.

    ``roundtrip`` saves every unit's cache columns, restores them, and
    writes the restored arrays back into the units — proving the store
    path is lossless and measuring its real (wall-clock) cost.  Each
    unit's ``residency`` is stamped with the store class it staged
    through.  ``put``/``fetch`` are the persistent variants used by
    recovery checkpoints: the payload stays in the store under its key
    until ``discard``.

    Fault injection: ``arm_failures(k)`` makes the next ``k`` staging
    operations raise :class:`EndpointUnavailable`; every op runs under
    retry-with-backoff (``retries`` / ``backoff_s`` account the cost),
    so transient store outages never lose a unit — only slow it down.
    """

    kind = RESIDENCY_HOST

    def __init__(self, store=None, *, device="cuda", max_retries: int = 6,
                 backoff_base: float = 0.05):
        self.device = resolve_device(device)
        self.store = store if store is not None else self._default_store()
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self._fail_next = 0
        self.retries = 0          # staging ops that needed a retry
        self.backoff_s = 0.0      # accounted backoff (virtual seconds)

    def _default_store(self):
        return InMemoryStore()

    @property
    def restore_device(self) -> torch.device:
        """Where restored payloads land: the host for host staging."""
        return torch.device("cpu")

    # ------------------------------------------------- fault injection
    def arm_failures(self, count: int):
        """The next ``count`` staging ops fail transiently."""
        self._fail_next += int(count)

    def _with_retry(self, op):
        delay = self.backoff_base
        for attempt in range(self.max_retries + 1):
            try:
                if self._fail_next > 0:
                    self._fail_next -= 1
                    raise EndpointUnavailable(
                        "staging store unavailable (injected fault)")
                return op()
            except EndpointUnavailable:
                if attempt == self.max_retries:
                    raise
                self.retries += 1
                self.backoff_s += delay
                delay *= 2.0

    # ------------------------------------------------------- staging
    def roundtrip(self, units: List[WorkUnit],
                  name: str) -> Tuple[float, float]:
        """Stage ``units`` through the store; returns real
        (checkpoint_s, restore_s) stage seconds."""
        if not units:
            return 0.0, 0.0

        def op():
            ck0 = self.store.timer.stages.get("checkpoint", 0.0)
            rs0 = self.store.timer.stages.get("restore", 0.0)
            self.store.save(name, [u.snapshot.cache for u in units])
            caches = self.store.restore(name, device=self.restore_device)
            ckpt_s = self.store.timer.stages["checkpoint"] - ck0
            restore_s = self.store.timer.stages["restore"] - rs0
            for u, c in zip(units, caches):
                u.snapshot.cache = dict(c)
                u.residency = self.kind
            self.store.drop(name)
            return ckpt_s, restore_s
        return self._with_retry(op)

    # ---------------------------------------------------- checkpoints
    def put(self, units: List[WorkUnit], name: str) -> float:
        """Persist the units' cache columns under ``name`` (recovery
        checkpoint); returns real checkpoint stage seconds."""
        if not units:
            return 0.0

        def op():
            ck0 = self.store.timer.stages.get("checkpoint", 0.0)
            self.store.save(name, [u.snapshot.cache for u in units])
            return self.store.timer.stages["checkpoint"] - ck0
        return self._with_retry(op)

    def fetch(self, units: List[WorkUnit], name: str) -> float:
        """Restore ``name``'s payloads back into ``units`` (recovery
        landing); returns real restore stage seconds."""
        if not units or not self.store.exists(name):
            return 0.0

        def op():
            rs0 = self.store.timer.stages.get("restore", 0.0)
            caches = self.store.restore(name, device=self.restore_device)
            restore_s = self.store.timer.stages["restore"] - rs0
            for u, c in zip(units, caches):
                u.snapshot.cache = dict(c)
                u.residency = self.kind
            return restore_s
        return self._with_retry(op)

    def discard(self, name: str):
        self.store.drop(name)


class HostEndpoint(MigrationEndpoint):
    """Host-RAM staging (``InMemoryStore``, the shm analogue)."""

    kind = RESIDENCY_HOST


class DeviceEndpoint(MigrationEndpoint):
    """Device-resident staging (``DeviceStore``, the daemon analogue)."""

    kind = RESIDENCY_DEVICE

    def _default_store(self):
        return DeviceStore(device=self.device)

    @property
    def restore_device(self) -> torch.device:
        return self.device


ENDPOINTS = {"host": HostEndpoint, "device": DeviceEndpoint}


def make_endpoint(kind: str, store=None, *,
                  device="cuda") -> MigrationEndpoint:
    if kind not in ENDPOINTS:
        raise ValueError(f"unknown migration endpoint {kind!r}; "
                         f"choose from {sorted(ENDPOINTS)}")
    return ENDPOINTS[kind](store, device=device)
