"""SimEngine: the ServingEngine's exact host-side twin, minus the device.

Port of ``repro.serving.simengine``: host arithmetic only, with the port's
``Request``, ``SlotSnapshot`` and ``WorkUnit``.

A 10^6-request scenario cannot run real decode in CI minutes —
and doesn't need to: the cluster layers (router, preemptor, autoscaler,
chaos recovery, metrics) only ever observe the engine through its
host-side projection (fed counts, slot costs, completions, WorkUnits).
``SimEngine`` implements that projection directly: the same admission
order, the same ``step_many`` accounting arithmetic (steps / emitted /
processed / chunk_tokens), the same pack/unpack/preempt/resume verb set
over ``SlotSnapshot``s — with "decode" producing deterministic
pseudo-tokens that are a pure function of ``(request rid, position)``,
so pack/resume/replay round-trips are bit-identical by construction.

Drop-in: ``Replica(engine_cls=SimEngine)`` /
``ServingCluster(engine="sim")``.  ``cfg`` and ``params`` are accepted
and ignored, so cluster scenarios swap engines without touching their
setup.  What it does NOT simulate: real cache contents (snapshots carry
an empty ``cache`` dict), paged-pool block pressure, EOS early exit,
and temperature sampling (tokens are deterministic regardless).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import (DEFAULT_PREFILL_DISCOUNT,
                                        Request, SlotSnapshot,
                                        request_cost)


def sim_token(rid: int, index: int, vocab: int = 50_000) -> int:
    """The deterministic pseudo-token stream: output ``index`` of request
    ``rid``.  A pure function, so any pack/resume/replay interleaving
    regenerates the identical stream."""
    return (rid * 1_000_003 + index * 7_919) % vocab


class SimEngine:
    """Token-accounting ServingEngine twin (no device)."""

    def __init__(self, cfg=None, params=None, *, batch_size: int = 4,
                 max_seq: int = 128, temperature: float = 0.0,
                 seed: int = 0, prefill_mode: str = "chunked",
                 prefill_discount: float = DEFAULT_PREFILL_DISCOUNT,
                 decode_block: int = 8, eos_token: Optional[int] = None,
                 **_ignored):
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_seq = max_seq
        self.temperature = temperature
        self.prefill_mode = prefill_mode
        self.prefill_discount = prefill_discount
        self.decode_block = max(int(decode_block), 1)
        self.eos_token = eos_token
        self.cache_mode = "sim"
        self.block_size = 0
        self.pool_blocks = 0
        self._alloc = None
        self._slots: List[Optional[Request]] = [None] * batch_size
        self._queue: List[Request] = []
        self._restore: List = []          # WorkUnits awaiting admission
        self._unit_meta: Dict[int, Tuple[int, list, Optional[int]]] = {}
        self._completed: List[Request] = []
        self._fed = np.zeros(batch_size, np.int64)
        self._plen = np.ones(batch_size, np.int64)
        self._maxfed = np.zeros(batch_size, np.int64)
        self._next_tok_host = np.zeros(batch_size, np.int64)
        self._out_read = np.zeros(batch_size, np.int64)
        self.processed_tokens = 0
        self.host_syncs = 0               # no device: stays 0 forever
        self.chunk_prefills = 0
        self.preemptions = 0
        self.resumes = 0
        self.resizes = 0
        self.resize_evictions = 0
        self._peak_slots = 0
        self._chunk_tokens_pending = 0

    # ------------------------------------------------------------- requests
    def submit(self, req: Request):
        if len(req.prompt) > self.max_seq - 1:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"cannot fit a max_seq={self.max_seq} cache")
        self._queue.append(req)

    def reclaim_queue(self) -> List[Request]:
        queued, self._queue = self._queue, []
        return queued

    def pop_completed(self) -> List[Request]:
        done, self._completed = self._completed, []
        return done

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def n_queued(self) -> int:
        return len(self._queue) + len(self._restore)

    @property
    def free_slots(self) -> int:
        return self.batch - self.n_active

    def occupancy(self) -> Dict[str, int]:
        return {
            "active_slots": self.n_active,
            "max_concurrent_slots": self._peak_slots,
            "blocks_in_use": 0,
            "peak_blocks_in_use": 0,
            "pool_blocks": 0,
        }

    def fed_tokens(self, slot: int) -> int:
        return int(self._fed[slot])

    def queued_requests(self) -> Tuple[Request, ...]:
        return tuple(self._queue)

    def slot_requests(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self._slots) if r is not None]

    def backlog_tokens(self) -> float:
        d = self.prefill_discount
        load = sum(cost for _, cost in self.slot_costs())
        load += sum(u.snapshot.remaining_cost(d) for u in self._restore)
        load += sum(request_cost(r, d) for r in self._queue)
        return load

    def restore_costs(self, discount: Optional[float] = None) -> List[float]:
        d = self.prefill_discount if discount is None else discount
        return [u.snapshot.remaining_cost(d) for u in self._restore]

    def slot_costs(self) -> List[Tuple[int, float]]:
        d = self.prefill_discount
        out = []
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            rem = max(int(self._maxfed[slot] - self._fed[slot]), 1)
            rem_prefill = min(
                max(int(self._plen[slot] - 1 - self._fed[slot]), 0), rem)
            out.append((slot, rem_prefill * d + (rem - rem_prefill)))
        return out

    # ------------------------------------------------------------ admission
    def _req_maxfed(self, req: Request) -> int:
        return min(len(req.prompt) + req.max_new_tokens - 1,
                   self.max_seq - 1)

    def _next_tok(self, req: Request, fed: int, plen: int) -> int:
        """Token to feed at cache position ``fed``: prompt while it
        lasts, then the deterministic output stream."""
        if fed < plen:
            return int(req.prompt[fed])
        return sim_token(req.rid, fed - plen)

    def _admit_fresh(self, req: Request, slot: int):
        P = len(req.prompt)
        n_fed = max(P - 1, 0)
        if n_fed:
            # the whole prefill rides one bulk chunk (the dense chunked
            # engine's common case); accounted identically
            self.chunk_prefills += 1
            self._chunk_tokens_pending += n_fed
        self._slots[slot] = req
        self._out_read[slot] = 0
        self._fed[slot] = n_fed
        self._plen[slot] = P
        self._maxfed[slot] = self._req_maxfed(req)
        self._next_tok_host[slot] = self._next_tok(req, n_fed, P)

    def _install(self, snap: SlotSnapshot, slot: int):
        req = snap.request
        self._slots[slot] = req
        self._out_read[slot] = len(req.out_tokens)
        self._fed[slot] = snap.fed
        self._plen[slot] = len(req.prompt)
        self._maxfed[slot] = self._req_maxfed(req)
        self._next_tok_host[slot] = snap.next_tok

    def _admit(self):
        for slot in range(self.batch):
            if self._slots[slot] is not None:
                continue
            if self._restore:
                u = self._restore.pop(0)
                self._install(u.snapshot, slot)
                self._unit_meta[slot] = (u.uid, u.hops, u.origin)
            elif self._queue:
                self._admit_fresh(self._queue.pop(0), slot)
        self._peak_slots = max(self._peak_slots, self.n_active)

    # ------------------------------------------------------------- stepping
    def step_many(self, n_steps: int) -> Dict[str, int]:
        """Admit, then advance every occupied slot ``n_steps`` feeds
        (capped at its maxfed) — the exact accounting arithmetic of
        ``ServingEngine.step_many``, with no device dispatch behind it.
        """
        self._chunk_tokens_pending = 0
        self._admit()
        chunk_tokens = self._chunk_tokens_pending
        stats = {"steps": 0, "emitted": 0, "processed": chunk_tokens,
                 "chunk_tokens": chunk_tokens}
        occupied = [i for i, r in enumerate(self._slots) if r is not None]
        if not occupied:
            self.processed_tokens += stats["processed"]
            return stats
        stats["steps"] = n_steps
        done_any = False
        for slot in occupied:
            before = int(self._fed[slot])
            after = min(before + n_steps, int(self._maxfed[slot]))
            self._fed[slot] = after
            plen = int(self._plen[slot])
            self._next_tok_host[slot] = self._next_tok(
                self._slots[slot], after, plen)
            stats["processed"] += after - before
            stats["emitted"] += (max(0, after - plen + 1)
                                 - max(0, before - plen + 1))
            if after >= self._maxfed[slot]:
                done_any = True
        self.processed_tokens += stats["processed"]
        if done_any:
            self._poll()
        return stats

    def step(self) -> int:
        return self.step_many(1)["emitted"]

    def run_until_idle(self, max_steps: int = 10_000) -> Dict[str, float]:
        tokens = 0
        steps = 0
        while (any(r is not None for r in self._slots) or self._queue
               or self._restore) and steps < max_steps:
            block = min(self.decode_block, max_steps - steps)
            out = self.step_many(block)
            tokens += out["emitted"]
            steps += max(out["steps"], 1)
        return {"tokens": tokens, "steps": steps, "seconds": 0.0,
                "tok_per_s": 0.0}

    def _poll(self):
        """Materialize progress into the Request objects (same contract
        as the device poll: emitted tokens appended, finished slots
        harvested to ``_completed``)."""
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            fed = int(self._fed[slot])
            plen = int(self._plen[slot])
            n = max(0, fed - plen + 1)
            for i in range(int(self._out_read[slot]), n):
                req.out_tokens.append(sim_token(req.rid, i))
            self._out_read[slot] = n
            if fed >= self._maxfed[slot]:
                req.done = True
                self._completed.append(req)
                self._slots[slot] = None
                self._unit_meta.pop(slot, None)

    # ----------------------------------------------- WorkUnit pack/unpack
    def _snapshot_slots(self, slots: Optional[List[int]] = None
                        ) -> List[Tuple[int, SlotSnapshot]]:
        self._poll()
        occupied = [i for i, r in enumerate(self._slots)
                    if r is not None and (slots is None or i in slots)]
        snaps = []
        for slot in occupied:
            req = self._slots[slot]
            snaps.append((slot, SlotSnapshot(
                request=req,
                fed=int(self._fed[slot]),
                next_tok=int(self._next_tok_host[slot]),
                cache_len=int(self._fed[slot]),
                cache={},        # no device cache: the pseudo-token
            )))                  # stream regenerates from (rid, index)
            self._slots[slot] = None
        return snaps

    def pack(self, slots: Optional[List[int]] = None) -> List:
        from repro_torch.serving.workunit import WorkUnit
        units = []
        for slot, snap in self._snapshot_slots(slots):
            meta = self._unit_meta.pop(slot, None)
            if meta is None:
                units.append(WorkUnit(snapshot=snap))
            else:
                uid, hops, origin = meta
                units.append(WorkUnit(snapshot=snap, uid=uid, hops=hops,
                                      origin=origin))
        return units

    def unpack(self, units: List):
        self._restore.extend(units)

    def slot_provenance(self) -> Dict[int, Tuple[int, tuple]]:
        return {slot: (uid, tuple(hops))
                for slot, (uid, hops, _origin) in self._unit_meta.items()}

    def preempt(self, slots: Optional[List[int]] = None) -> List:
        from repro_torch.serving.workunit import PAUSED
        units = self.pack(slots)
        for u in units:
            u.state = PAUSED
        self.preemptions += len(units)
        return units

    def resume(self, units: List):
        from repro_torch.serving.workunit import PACKED
        for u in units:
            u.state = PACKED
        self.resumes += len(units)
        self.unpack(units)

    def drain_units(self) -> Tuple[List, List[Request]]:
        units = self.pack()
        units.extend(self._restore)
        self._restore = []
        queued, self._queue = self._queue, []
        return units, queued

    def pending_units(self) -> tuple:
        return tuple(self._restore)

    def checkpoint_units(self) -> List:
        from repro_torch.serving.workunit import WorkUnit
        self._poll()
        units = []
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            frozen = dataclasses.replace(
                req, out_tokens=list(req.out_tokens))
            snap = SlotSnapshot(
                request=frozen,
                fed=int(self._fed[slot]),
                next_tok=int(self._next_tok_host[slot]),
                cache_len=int(self._fed[slot]),
                cache={},
            )
            meta = self._unit_meta.get(slot)
            if meta is None:
                units.append(WorkUnit(snapshot=snap))
            else:
                uid, hops, origin = meta
                units.append(WorkUnit(snapshot=snap, uid=uid,
                                      hops=list(hops), origin=origin))
        return units

    # ------------------------------------------------- vertical elasticity
    def resize(self, *, batch_size: Optional[int] = None,
               decode_block: Optional[int] = None,
               kv_pool_blocks: Optional[int] = None,
               evict_key=None) -> List:
        """Exact mirror of ``ServingEngine.resize`` minus the device:
        repack live slots, rebuild the host mirrors at the new lane
        count, re-admit survivors ahead of the queue, return evictees as
        ``PAUSED`` units.  ``kv_pool_blocks`` is accepted and ignored
        (the sim has no block pool), matching the constructor contract.
        """
        from repro_torch.serving.engine import ServingEngine
        from repro_torch.serving.workunit import PAUSED
        del kv_pool_blocks
        new_batch = self.batch if batch_size is None else int(batch_size)
        if new_batch < 1:
            raise ValueError(f"batch_size must be >= 1, got {new_batch}")
        if decode_block is not None:
            self.decode_block = max(int(decode_block), 1)
        if new_batch == self.batch:
            return []
        units = self.pack()
        units.sort(key=evict_key or ServingEngine._default_evict_key)
        keep, evicted = units[:new_batch], units[new_batch:]
        self.batch = new_batch
        self._slots = [None] * new_batch
        self._unit_meta = {}
        self._fed = np.zeros(new_batch, np.int64)
        self._plen = np.ones(new_batch, np.int64)
        self._maxfed = np.zeros(new_batch, np.int64)
        self._next_tok_host = np.zeros(new_batch, np.int64)
        self._out_read = np.zeros(new_batch, np.int64)
        self._restore = keep + self._restore
        for u in evicted:
            u.state = PAUSED
        self.resizes += 1
        self.resize_evictions += len(evicted)
        self._admit()
        return evicted
