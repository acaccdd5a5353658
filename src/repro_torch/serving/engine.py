"""Serving engine: continuous-batching decode over the model zoo.

Port of ``repro.serving.engine`` in ``cache_mode="dense"`` and
``"paged"``: the request queue, slot-based batching (a fixed decode batch
of ``batch_size`` slots; finished sequences release their slot to the
next request), chunked bulk prefill, greedy or temperature sampling.

* **Chunked bulk prefill** — a request is admitted by running the
  prefill over a fixed padded chunk bucket and writing the resulting
  cache columns into its slot.  A paged engine keeps appending
  state-continued chunks for prompts past the largest bucket.
* **Sync-free batched decode** — ``step_many(k)`` runs k fused
  sample-and-advance steps with the ``SampleState`` on the device.  The
  host tracks progress with an *exact* projection, so steady-state
  decode performs **zero device->host transfers**; ``out_buf`` is
  fetched only when the projection says a slot completed.
  ``host_syncs`` counts every fetch.
* **Paged KV cache** — kv lives in ONE device block pool addressed
  through per-lane block tables; its decode attention is the
  hand-written CUDA kernel of ``kernels/paged_attention``.  A
  ``BlockAllocator`` reserves a slot's whole block budget at admission,
  so the fused decode window never allocates.

* **Migratable work units** — ``pack()`` captures each occupied slot
  (request progress + that slot's cache columns, on the host) into a
  self-contained ``WorkUnit``; ``unpack()`` admits units into any engine
  built from the same ``(cfg, max_seq)``, dense or paged, of any block
  size, including one of the JAX package.  ``preempt``/``resume`` are
  the same checkpoint under pause semantics, ``checkpoint_units`` the
  non-destructive one, and ``resize`` changes the lane count or the
  pool in place through the same path.  A pack gathers only the packed
  slots' rows or blocks on the device and copies them to the host in
  one counted fetch; an install writes them back without waiting for
  the device.

In eager PyTorch there is no compile step to share between engines, so
the reference's ``_LOOP_CACHE`` / ``_PREFILL_CACHE`` have no counterpart:
the decode and prefill closures are cheap to build and are built per
engine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo as zoo

# Padded prompt-chunk sizes for bulk prefill.  Ascending; buckets larger
# than the engine's cache are dropped at construction.
DEFAULT_PREFILL_BUCKETS: Tuple[int, ...] = (16, 64, 256)

# Relative cost of one bulk-prefilled prompt token vs one decode step
# (the router's and the cluster's load unit).
DEFAULT_PREFILL_DISCOUNT = 0.35

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (len,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slo: Optional[Any] = None
    model_id: str = "default"
    arrival_t: Optional[float] = None

    @property
    def total_tokens(self) -> int:
        """Token-units of work: prompt + planned new tokens (LB load)."""
        return len(self.prompt) + self.max_new_tokens

    def deadline_t(self, default: float = float("inf")) -> float:
        """Absolute completion deadline (inf when class-less/unarrived)."""
        if self.slo is None or self.arrival_t is None:
            return default
        return self.arrival_t + self.slo.deadline


def request_cost(req: Request,
                 discount: float = DEFAULT_PREFILL_DISCOUNT) -> float:
    """Router load of an unstarted request, with prefill discounted: the
    last prompt token doubles as the first decode feed, so
    ``len(prompt) - 1`` tokens ride the discounted prefill path."""
    return max(len(req.prompt) - 1, 0) * discount + req.max_new_tokens


@dataclasses.dataclass
class SlotSnapshot:
    """A checkpointed in-flight request: enough to resume decode anywhere.

    ``cache`` holds the slot's columns in ONE canonical layout — full
    contiguous ``max_seq`` sequence axes — whatever cache mode produced
    it: a paged engine gathers the slot's blocks through its table into
    the contiguous column on ``pack`` and re-blocks into its own
    geometry on ``unpack``, so snapshots move between dense and paged
    engines and between block sizes bit for bit.

    The columns are CPU torch tensors in the leaf's own dtype (bf16 kv,
    float32 ssm, conv in ``model_zoo.conv_dtype``): numpy has no
    bfloat16 without ``ml_dtypes``, and a CPU tensor holds bf16 exactly, can be pinned
    for the copy back to the card, and is what the checkpoint stores
    keep.  ``unpack`` also reads the JAX package's snapshots, whose
    columns are numpy arrays (bf16 ones as ``ml_dtypes.bfloat16``, read
    through an int16 view, see ``host_column``).

    ``rng`` is the sampler's ``torch.Generator`` state at checkpoint
    time (``get_state()``), stamped by ``checkpoint_units`` so that a
    temperature > 0 stream resumed into an otherwise-empty engine replays
    its lost tail bit for bit; migration snapshots leave it None (the
    live generator keeps advancing).
    """
    request: Request
    fed: int                    # prompt+generated tokens already in cache
    next_tok: int               # next token to feed
    cache_len: int
    cache: Dict[str, Any]       # this slot's cache columns (host)
    rng: Optional[Any] = None

    @property
    def remaining_tokens(self) -> int:
        return max(self.request.total_tokens - self.fed, 1)

    def remaining_cost(self,
                       discount: float = DEFAULT_PREFILL_DISCOUNT) -> float:
        """Remaining load with the not-yet-fed prefill part discounted."""
        rem = self.remaining_tokens
        rem_prefill = min(max(len(self.request.prompt) - 1 - self.fed, 0),
                          rem)
        return rem_prefill * discount + (rem - rem_prefill)


def host_column(col) -> torch.Tensor:
    """A snapshot column as a CPU tensor: the port's own columns pass
    through; a numpy array (the JAX package's snapshots) is wrapped
    (copied only if read-only), a ``bfloat16`` one through its int16
    bits so that no ``ml_dtypes`` import is needed."""
    if isinstance(col, torch.Tensor):
        return col
    arr = np.ascontiguousarray(col)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class BlockAllocator:
    """Free-list allocator over the paged cache's physical block pool.

    Pure host-side bookkeeping: a slot's whole reservation is taken in
    one ``allocate`` at admission and returned in one ``release`` at
    retire; ``allocate`` on an owning slot and ``release`` on a
    non-owning slot raise (leak/double-free detection, not silence).
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._owned: Dict[int, Tuple[int, ...]] = {}
        self.peak_in_use = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def owned(self, slot: int) -> Tuple[int, ...]:
        return self._owned.get(slot, ())

    def allocate(self, slot: int, n: int) -> Tuple[int, ...]:
        if slot in self._owned:
            raise ValueError(f"slot {slot} already owns blocks (leak)")
        if n > len(self._free):
            raise ValueError(
                f"pool exhausted: want {n}, free {len(self._free)}")
        blocks = tuple(self._free.pop() for _ in range(max(n, 0)))
        self._owned[slot] = blocks
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return blocks

    def release(self, slot: int) -> Tuple[int, ...]:
        if slot not in self._owned:
            raise ValueError(f"slot {slot} owns no blocks (double free)")
        blocks = self._owned.pop(slot)
        self._free.extend(reversed(blocks))
        return blocks

    def check_invariants(self):
        """Raises unless free + owned exactly partition the pool."""
        free = set(self._free)
        owned = [b for bs in self._owned.values() for b in bs]
        assert len(free) == len(self._free), "duplicate free blocks"
        assert len(set(owned)) == len(owned), "block owned twice"
        assert not (free & set(owned)), "block both free and owned"
        assert len(free) + len(owned) == self.num_blocks, "blocks leaked"


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch_size: int = 4,
                 max_seq: int = 128, temperature: float = 0.0, seed: int = 0,
                 prefill_mode: str = "chunked",
                 prefill_buckets: Tuple[int, ...] = DEFAULT_PREFILL_BUCKETS,
                 prefill_discount: float = DEFAULT_PREFILL_DISCOUNT,
                 decode_block: int = 8, eos_token: Optional[int] = None,
                 cache_mode: str = "dense", block_size: int = 16,
                 kv_pool_blocks: Optional[int] = None, device="cuda"):
        if prefill_mode not in ("chunked", "streamed"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if cache_mode not in ("dense", "paged"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.max_seq = max_seq
        self.temperature = temperature
        self.prefill_mode = prefill_mode
        self.prefill_discount = prefill_discount
        self.decode_block = max(int(decode_block), 1)
        # device-side EOS early exit: the host projection can no longer
        # predict completion, so eos engines reconcile against device
        # truth after every window
        self.eos_token = eos_token
        self.cache_mode = cache_mode
        self.shape = ShapeConfig("serve", max_seq, batch_size, "decode")
        if cache_mode == "paged":
            if max_seq % block_size:
                raise ValueError(
                    f"max_seq={max_seq} not a multiple of "
                    f"block_size={block_size}")
            self.block_size = block_size
            self.max_blocks = max_seq // block_size
            # default pool = exactly the dense engine's kv memory; a
            # smaller pool trades ceiling for memory (admission gates on
            # free blocks, so it degrades to queueing, never OOM)
            self.pool_blocks = (batch_size * self.max_blocks
                                if kv_pool_blocks is None
                                else int(kv_pool_blocks))
            self.state = zoo.init_paged_decode_state(
                cfg, self.shape, block_size, self.pool_blocks, self.device)
            self._alloc: Optional[BlockAllocator] = BlockAllocator(
                self.pool_blocks)
            # host mirror of the device block tables
            self._tables = np.full((batch_size, self.max_blocks),
                                   self.pool_blocks, np.int32)
        else:
            self.block_size = 0
            self.pool_blocks = 0
            self.state = zoo.init_decode_state(cfg, self.shape, fill_len=0,
                                               device=self.device)
            self._alloc = None
            self._tables = None
        self.sample = zoo.init_sample_state(cfg, self.shape, seed=seed,
                                            device=self.device)
        self._prompt_buf = torch.zeros((batch_size, max_seq),
                                       dtype=torch.int32, device=self.device)
        self._slots: List[Optional[Request]] = [None] * batch_size
        self._queue: List[Request] = []
        self._restore: List["WorkUnit"] = []
        # per-slot provenance of restored units: slot -> (uid, hops,
        # origin).  ``pack`` re-uses it so a unit keeps ONE identity and
        # one hop history across any number of pack->unpack round trips.
        self._unit_meta: Dict[int, Tuple[int, list, Optional[int]]] = {}
        self._completed: List[Request] = []
        # exact host mirrors of the device progress counters: advanced by
        # projection after every decode window, overwritten with device
        # truth at every poll
        self._fed = np.zeros(batch_size, np.int64)
        self._plen = np.ones(batch_size, np.int64)
        self._maxfed = np.zeros(batch_size, np.int64)
        self._next_tok_host = np.zeros(batch_size, np.int64)
        self._out_read = np.zeros(batch_size, np.int64)
        self.processed_tokens = 0   # prefill + decode work units (rate feed)
        self.host_syncs = 0         # device->host fetches (poll/drain only)
        self.chunk_prefills = 0     # bulk prefill dispatches issued
        self.preemptions = 0        # slots paused via preempt()
        self.resumes = 0            # paused units re-admitted via resume()
        self.resizes = 0            # in-place geometry changes via resize()
        self.resize_evictions = 0   # slots evicted (paused) by a shrink
        self._peak_slots = 0        # high-water concurrent occupied slots
        self._chunk_tokens_pending = 0
        if prefill_mode == "chunked" and cfg.family in zoo.BULK_PREFILL_FAMILIES:
            self._buckets = tuple(sorted(
                c for c in prefill_buckets if 0 < c <= max_seq))
        else:
            self._buckets = ()
        if not self._buckets:
            # no bulk path: every prompt token costs a full decode step,
            # so backlog must not discount prefill work
            self.prefill_discount = 1.0
        # decode loops and prefill closures of the current geometry
        # (they capture ``shape`` and ``pool_blocks``; ``resize`` drops
        # them)
        self._loops: Dict[int, Any] = {}
        self._prefills: Dict[Tuple[int, bool], Any] = {}
        # per-leaf batch axis of the cache (slot slicing/placement): the
        # lane axis of dense k/v and of the recurrent leaves, and the
        # block axis of a paged pool, which is axis 1 like dense k/v's
        self._cache_axes = {
            k: zoo.lane_axis(self.cfg) if k in ("ssm", "conv") else 1
            for k in self.state.cache}

    # ------------------------------------------------------------- requests
    def submit(self, req: Request):
        if len(req.prompt) > self.max_seq - 1:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"cannot fit a max_seq={self.max_seq} cache")
        self._queue.append(req)

    def reclaim_queue(self) -> List[Request]:
        """Hand not-yet-admitted requests back (router re-dispatch)."""
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
        """Admittable-request capacity: free lanes, and for a paged engine
        also free pool blocks at the per-request need of its pending work
        (else the mean reservation of running slots, else ``max_seq``)."""
        lanes = self.batch - self.n_active
        if self._alloc is None or lanes == 0:
            return lanes
        est = self._est_blocks_per_request()
        return min(lanes, self._alloc.free_count // max(est, 1))

    def _est_blocks_per_request(self) -> int:
        reqs = [u.snapshot.request for u in self._restore] + self._queue
        if reqs:
            need = [self._blocks_needed(self._req_maxfed(r)) for r in reqs]
            return max(1, round(sum(need) / len(need)))
        owned = [len(self._alloc.owned(s)) for s, r in
                 enumerate(self._slots) if r is not None]
        if owned:
            return max(1, round(sum(owned) / len(owned)))
        return self.max_blocks

    def occupancy(self) -> Dict[str, int]:
        """Slot/block occupancy counters."""
        return {
            "active_slots": self.n_active,
            "max_concurrent_slots": self._peak_slots,
            "blocks_in_use": self._alloc.in_use if self._alloc else 0,
            "peak_blocks_in_use":
                self._alloc.peak_in_use if self._alloc else 0,
            "pool_blocks": self.pool_blocks,
        }

    # ----------------------------------------------------- block lifecycle
    def _req_maxfed(self, req: Request) -> int:
        return min(len(req.prompt) + req.max_new_tokens - 1,
                   self.max_seq - 1)

    def _blocks_needed(self, maxfed: int) -> int:
        """Blocks covering every position a slot will ever write
        (``0 .. maxfed-1``), reserved up front."""
        return max(1, -(-int(maxfed) // self.block_size))

    def _write_table_row(self, slot: int, blocks: Tuple[int, ...]):
        """Install ``slot``'s block mapping: host mirror + ONE device row
        write (sentinel-fill past the mapped prefix)."""
        self._tables[slot] = self.pool_blocks
        self._tables[slot, :len(blocks)] = blocks
        self.state.block_tables[slot] = self._to_device(self._tables[slot])

    def _release_blocks(self, slot: int):
        """Return a retiring slot's blocks and sentinel its host table row.
        The *device* row stays stale on purpose: a retired lane is
        inactive, so its decode writes go to the sink row, and the row is
        rewritten before the slot is dispatched again."""
        self._alloc.release(slot)
        self._tables[slot] = self.pool_blocks

    def fed_tokens(self, slot: int) -> int:
        """Tokens already in ``slot``'s cache (exact, no device sync)."""
        return int(self._fed[slot])

    def queued_requests(self) -> Tuple[Request, ...]:
        return tuple(self._queue)

    def slot_requests(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self._slots) if r is not None]

    def backlog_tokens(self) -> float:
        """Remaining load across slots + queue (the router's signal), with
        prefill-remaining tokens weighted by ``prefill_discount``."""
        d = self.prefill_discount
        load = sum(cost for _, cost in self.slot_costs())
        load += sum(u.snapshot.remaining_cost(d) for u in self._restore)
        load += sum(request_cost(r, d) for r in self._queue)
        return load

    def restore_costs(self, discount: Optional[float] = None) -> List[float]:
        """Remaining discounted load per not-yet-admitted restore-queue
        unit (they claim free slots ahead of fresh work)."""
        d = self.prefill_discount if discount is None else discount
        return [u.snapshot.remaining_cost(d) for u in self._restore]

    def slot_costs(self) -> List[Tuple[int, float]]:
        """Per occupied slot: (slot, remaining discounted load)."""
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
    def _pick_chunk(self, n_prefill: int,
                    room: Optional[int] = None) -> Tuple[int, int]:
        """Bulk-prefill bucket for ``n_prefill`` prompt tokens.

        Returns ``(bucket, n_real)`` — ``bucket`` = 0 means stream.
        Pad-safe (causal attention) families take the smallest bucket
        that covers the prompt and right-pad it; recurrent families take
        the largest fully-real bucket.  ``room`` caps the bucket at the
        cache positions left past the chunk's start offset; when no
        covering bucket fits, a fully-real bucket is used instead.
        """
        if not self._buckets or n_prefill <= 0:
            return 0, 0
        room = self.max_seq if room is None else room
        if self.cfg.family in zoo.PAD_SAFE_FAMILIES:
            for c in self._buckets:
                if n_prefill <= c <= room:
                    return c, n_prefill
            best = 0
            for c in self._buckets:
                if c <= min(n_prefill, room):
                    best = c
            return best, best
        best = 0
        chunk = max(self.cfg.ssm_chunk, 1)
        for c in self._buckets:
            if c <= min(n_prefill, room) and (c <= chunk or c % chunk == 0):
                best = c
        return best, best

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device
        (an H2D copy from pageable memory is staged at once)."""
        return torch.from_numpy(arr).to(self.device, non_blocking=True)

    def _set_cache_len(self, slot: int, value: int):
        self.state.cache_len[slot].fill_(value)

    def _set_sample_row(self, slot: int, *, next_tok: int, fed: int,
                        plen: int, maxfed: int, prompt: np.ndarray,
                        active: int = 1):
        row = np.zeros(self.max_seq, np.int32)
        row[:len(prompt)] = prompt
        s = self.sample
        # fill_ on a view: a Python number assigned by indexing is copied
        # from the host with a stream sync
        s.next_tok[slot, 0].fill_(next_tok)
        s.active[slot].fill_(active)
        s.fed[slot].fill_(fed)
        s.plen[slot].fill_(plen)
        s.maxfed[slot].fill_(maxfed)
        s.out_buf[slot].zero_()
        self._prompt_buf[slot] = self._to_device(row)
        self._fed[slot] = fed
        self._plen[slot] = plen
        self._maxfed[slot] = maxfed
        self._next_tok_host[slot] = next_tok

    def _chunk_tokens(self, req: Request, start: int, chunk: int,
                      n_real: int) -> torch.Tensor:
        ctoks = np.zeros((1, chunk), np.int32)
        ctoks[0, :n_real] = req.prompt[start:start + n_real]
        return self._to_device(ctoks)

    def _bulk(self, chunk: int):
        key = (chunk, False)
        if key not in self._prefills:
            self._prefills[key] = zoo.make_bulk_prefill(self.cfg, self.shape,
                                                        chunk)
        return self._prefills[key]

    def _paged_bulk(self, chunk: int, first: bool):
        key = (chunk, first)
        if key not in self._prefills:
            self._prefills[key] = zoo.make_paged_bulk_prefill(
                self.cfg, self.shape, chunk, self.block_size,
                self.pool_blocks, first_chunk=first)
        return self._prefills[key]

    def _admit_fresh(self, req: Request, slot: int):
        P = len(req.prompt)
        maxfed = self._req_maxfed(req)
        if self._alloc is not None:
            blocks = self._alloc.allocate(slot, self._blocks_needed(maxfed))
            self._write_table_row(slot, blocks)
            n_fed = self._paged_chunk_prefills(req, slot, 0, P - 1)
        else:
            chunk, n_real = self._pick_chunk(P - 1)
            if chunk:
                self.state = self._bulk(chunk)(
                    self.params, self.state,
                    self._chunk_tokens(req, 0, chunk, n_real), slot, n_real)
                self.chunk_prefills += 1
                self._chunk_tokens_pending += n_real
            else:
                self._set_cache_len(slot, 0)
            n_fed = n_real
        self._slots[slot] = req
        self._out_read[slot] = 0
        self._set_sample_row(slot, next_tok=int(req.prompt[n_fed]),
                             fed=n_fed, plen=P, maxfed=maxfed,
                             prompt=req.prompt)

    def _paged_chunk_prefills(self, req: Request, slot: int, start: int,
                              n_prefill: int) -> int:
        """Feed ``req.prompt[start : start + n_prefill]`` into ``slot`` by
        state-continued chunk prefills (block-table appends); prompts
        beyond the largest bucket keep appending chunks.  Returns the new
        fed count; if no bucket fits, the leftover streams."""
        off, remaining = start, n_prefill
        while remaining > 0:
            chunk, n_real = self._pick_chunk(remaining,
                                             room=self.max_seq - off)
            if not chunk:
                break
            self.state = self._paged_bulk(chunk, off == 0)(
                self.params, self.state,
                self._chunk_tokens(req, off, chunk, n_real), slot, off,
                n_real)
            self.chunk_prefills += 1
            self._chunk_tokens_pending += n_real
            off += n_real
            remaining -= n_real
        if off == start:
            self._set_cache_len(slot, start)
        return off

    def _can_admit(self, req: Request) -> bool:
        """Paged admission gate: the head-of-queue request must fit the
        free-block pool (FIFO, so admission order stays deterministic)."""
        if self._alloc is None:
            return True
        return self._alloc.can_allocate(
            self._blocks_needed(self._req_maxfed(req)))

    def _admit(self):
        """Fill free slots from the restore queue, then the request queue."""
        for slot in range(self.batch):
            if self._slots[slot] is not None:
                continue
            if self._restore:
                if not self._can_admit(self._restore[0].snapshot.request):
                    break
                u = self._restore.pop(0)
                self._install(u.snapshot, slot)
                # keep the unit's identity alive on the slot: a later
                # pack() re-emits the SAME uid and extends the same hop
                # history (the list object is shared)
                self._unit_meta[slot] = (u.uid, u.hops, u.origin)
            elif self._queue:
                if not self._can_admit(self._queue[0]):
                    break
                self._admit_fresh(self._queue.pop(0), slot)
        self._peak_slots = max(self._peak_slots, self.n_active)

    # ------------------------------------------------------------- stepping
    def _loop(self, n_steps: int):
        if n_steps not in self._loops:
            if self._alloc is not None:
                self._loops[n_steps] = zoo.make_paged_decode_loop(
                    self.cfg, self.shape, n_steps, self.block_size,
                    self.pool_blocks, self.temperature,
                    eos_token=self.eos_token)
            else:
                self._loops[n_steps] = zoo.make_decode_loop(
                    self.cfg, self.shape, n_steps, self.temperature,
                    eos_token=self.eos_token)
        return self._loops[n_steps]

    def step_many(self, n_steps: int) -> Dict[str, int]:
        """Admit, then run ``n_steps`` fused decode steps.

        Returns ``{"steps", "emitted", "processed", "chunk_tokens"}``,
        all from the host-side exact projection — the device is polled
        only when the projection says a slot finished.
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
        before = {slot: int(self._fed[slot]) for slot in occupied}
        self.state, self.sample = self._loop(n_steps)(
            self.params, self.state, self.sample, self._prompt_buf)
        stats["steps"] = n_steps
        if self.eos_token is not None:
            # EOS can end a slot at any inner step, invisibly to the host
            # projection: reconcile against device truth every window
            self._poll()
            for slot in occupied:
                after = int(self._fed[slot])
                plen = int(self._plen[slot])
                stats["processed"] += after - before[slot]
                stats["emitted"] += (max(0, after - plen + 1)
                                     - max(0, before[slot] - plen + 1))
            self.processed_tokens += stats["processed"]
            return stats
        done_any = False
        for slot in occupied:
            after = min(before[slot] + n_steps, int(self._maxfed[slot]))
            self._fed[slot] = after
            plen = int(self._plen[slot])
            stats["processed"] += after - before[slot]
            stats["emitted"] += (max(0, after - plen + 1)
                                 - max(0, before[slot] - plen + 1))
            if after >= self._maxfed[slot]:
                done_any = True
        self.processed_tokens += stats["processed"]
        if done_any:
            self._poll()
        return stats

    def step(self) -> int:
        """One engine step (admit + ONE fused decode); returns tokens
        emitted (generated tokens only — prefill doesn't count)."""
        return self.step_many(1)["emitted"]

    def run_until_idle(self, max_steps: int = 10_000) -> Dict[str, float]:
        t0 = time.perf_counter()
        tokens = 0
        steps = 0
        while (any(r is not None for r in self._slots) or self._queue
               or self._restore) and steps < max_steps:
            block = min(self.decode_block, max_steps - steps)
            out = self.step_many(block)
            tokens += out["emitted"]
            steps += max(out["steps"], 1)
        dt = time.perf_counter() - t0
        return {"tokens": tokens, "steps": steps, "seconds": dt,
                "tok_per_s": tokens / max(dt, 1e-9)}

    # ----------------------------------------------------------- host sync
    def _fetch(self, tensors) -> List[torch.Tensor]:
        """The ONLY device->host path in the engine (counted): every
        tensor is copied into pinned host memory, then the host waits
        once.  On the CPU the tensors are handed back as they are."""
        self.host_syncs += 1
        if self.device.type != "cuda":
            return list(tensors)
        out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
               .copy_(t, non_blocking=True) for t in tensors]
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def _poll(self):
        """Materialize device progress into the Request objects.  Called
        when the projection says a slot completed — never in the
        steady-state decode loop."""
        occupied = [i for i, r in enumerate(self._slots) if r is not None]
        if not occupied:
            return
        out_buf, fed, next_tok, active = (t.numpy() for t in self._fetch(
            (self.sample.out_buf, self.sample.fed, self.sample.next_tok,
             self.sample.active)))
        for slot in occupied:
            req = self._slots[slot]
            self._fed[slot] = int(fed[slot])
            self._next_tok_host[slot] = int(next_tok[slot, 0])
            n = max(0, int(fed[slot]) - int(self._plen[slot]) + 1)
            new = out_buf[slot, int(self._out_read[slot]):n]
            req.out_tokens.extend(int(t) for t in new)
            self._out_read[slot] = n
            # a device-deactivated occupied slot is finished — either it
            # reached maxfed, or it sampled the EOS token and early-exited
            if fed[slot] >= self._maxfed[slot] or int(active[slot]) == 0:
                req.done = True
                self._completed.append(req)
                self._slots[slot] = None
                self._unit_meta.pop(slot, None)
                if self._alloc is not None:
                    self._release_blocks(slot)

    # ----------------------------------------------- WorkUnit pack/unpack
    #
    # One verb set for every in-flight-request move (the paper's PUP
    # interface): ``pack``/``unpack`` for migration and drain,
    # ``preempt``/``resume`` for SLO-aware pausing, and the
    # non-destructive ``checkpoint_units`` for periodic recovery
    # checkpoints.

    def _install(self, snap: SlotSnapshot, slot: int):
        """Write a snapshot's cache columns into ``slot`` and resume it.

        Snapshots are canonical contiguous (full ``max_seq`` columns)
        whatever the source engine's cache mode or block size: a paged
        engine re-blocks them into its own geometry here.  Every write is
        an asynchronous copy to the device or a device op, so an install
        never waits for the device.
        """
        req = snap.request
        maxfed = self._req_maxfed(req)
        # recovery checkpoints carry the sampler state: restoring into an
        # otherwise-empty sampled engine replays the exact draws of the
        # lost tail (the generator is shared across slots, so a busy
        # engine — or a greedy one, which never draws — keeps its own)
        if (snap.rng is not None and self.temperature > 0
                and self.n_active == 0):
            if not (isinstance(snap.rng, torch.Tensor)
                    and snap.rng.dtype == torch.uint8):
                raise ValueError(
                    "snapshot rng is not a torch.Generator state (a unit "
                    "checkpointed by another package?); it cannot seed "
                    "this engine's sampler")
            self.sample.rng.set_state(snap.rng)
        kv_keys = (set(zoo.paged_kv_keys(self.cfg))
                   if self._alloc is not None else set())
        blocks: Tuple[int, ...] = ()
        if self._alloc is not None:
            blocks = self._alloc.allocate(slot, self._blocks_needed(maxfed))
            self._write_table_row(slot, blocks)
            block_idx = self._to_device(np.asarray(blocks, np.int64))
        for k, leaf in self.state.cache.items():
            ax = self._cache_axes[k]
            col = host_column(snap.cache[k]).to(self.device,
                                                non_blocking=True)
            if k in kv_keys:
                # contiguous column -> (max_blocks, block_size) at the seq
                # axis -> the reserved prefix scattered through the fresh
                # table (dense batch axis == paged block axis); the whole
                # column crosses in one contiguous copy and the prefix is
                # taken on the device
                sh = col.shape
                blocked = col.reshape(sh[:ax] + (self.max_blocks,
                                                 self.block_size)
                                      + sh[ax + 1:])
                leaf.index_copy_(ax, block_idx,
                                 blocked.narrow(ax, 0, len(blocks))
                                 .to(leaf.dtype))
            else:
                leaf.select(ax, slot).copy_(col)
        self._set_cache_len(slot, snap.cache_len)
        self._slots[slot] = req
        self._out_read[slot] = len(req.out_tokens)
        self._set_sample_row(slot, next_tok=snap.next_tok, fed=snap.fed,
                             plen=len(req.prompt), maxfed=maxfed,
                             prompt=req.prompt)

    def _slot_cols(self, slot: int, kv_keys) -> Dict[str, torch.Tensor]:
        """One slot's cache columns in the canonical contiguous layout,
        gathered on the device: a paged engine merges the slot's owned
        blocks (never the sink row) and pads to ``max_seq``, a dense one
        copies the batch row.  Every column is a fresh tensor."""
        cols = {}
        for k, leaf in self.state.cache.items():
            ax = self._cache_axes[k]
            if k in kv_keys:
                blocks = self._alloc.owned(slot)
                idx = self._to_device(np.asarray(blocks, np.int64))
                sh = leaf.shape
                col = leaf.new_zeros(sh[:ax] + (self.max_seq,) + sh[ax + 2:])
                blocked = col.view(sh[:ax] + (self.max_blocks,
                                              self.block_size) + sh[ax + 2:])
                blocked.narrow(ax, 0, len(blocks)).copy_(
                    leaf.index_select(ax, idx))
                cols[k] = col
            else:
                cols[k] = leaf.select(ax, slot).clone(
                    memory_format=torch.contiguous_format)
        return cols

    def _gather_slots(self, occupied: List[int]
                      ) -> List[Dict[str, torch.Tensor]]:
        """The canonical columns of ``occupied`` slots on the host: one
        gather per slot and leaf on the device, then ONE counted fetch of
        exactly those columns (the rest of the cache stays put)."""
        kv_keys = (set(zoo.paged_kv_keys(self.cfg))
                   if self._alloc is not None else set())
        dev_cols = [self._slot_cols(slot, kv_keys) for slot in occupied]
        keys = list(self.state.cache)
        host = iter(self._fetch([c[k] for c in dev_cols for k in keys]))
        return [{k: next(host) for k in keys} for _ in occupied]

    def _snapshot_slots(self, slots: Optional[List[int]] = None
                        ) -> List[Tuple[int, SlotSnapshot]]:
        """Checkpoint and release occupied slots (the PUP 'pack' step).

        ``slots`` restricts the checkpoint to a subset; None takes every
        occupied slot.  Works at any point in a request's life, including
        right after a bulk prefill chunk, before the prompt is fully fed.
        Returns ``(slot, snapshot)`` pairs so ``pack`` can look up
        per-slot unit provenance.
        """
        self._poll()
        occupied = [i for i, r in enumerate(self._slots)
                    if r is not None and (slots is None or i in slots)]
        if not occupied:
            return []
        snaps = []
        for slot, cols in zip(occupied, self._gather_slots(occupied)):
            snaps.append((slot, SlotSnapshot(
                request=self._slots[slot],
                fed=int(self._fed[slot]),
                next_tok=int(self._next_tok_host[slot]),
                cache_len=int(self._fed[slot]),
                cache=cols,
            )))
            self._slots[slot] = None
            if self._alloc is not None:
                self._release_blocks(slot)
            self.sample.active[slot].zero_()   # a device write, no sync
        return snaps

    def pack(self, slots: Optional[List[int]] = None) -> List["WorkUnit"]:
        """Checkpoint + release occupied slots as migratable ``WorkUnit``s.

        A packed unit is self-contained: ``unpack`` admits it into any
        engine built from the same ``(cfg, max_seq)`` and the greedy
        stream continues bit-identically.  A slot that was itself
        restored from a unit re-emits that unit's ``uid``, hop history
        and origin.
        """
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

    def unpack(self, units: List["WorkUnit"]):
        """Queue packed units for admission (cache written on admit),
        ahead of fresh queued requests."""
        self._restore.extend(units)

    def slot_provenance(self) -> Dict[int, Tuple[int, Tuple["Hop", ...]]]:
        """Per restored slot: ``(unit uid, hop history so far)``."""
        return {slot: (uid, tuple(hops))
                for slot, (uid, hops, _origin) in self._unit_meta.items()}

    def preempt(self, slots: Optional[List[int]] = None) -> List["WorkUnit"]:
        """Pause slots mid-stream: slot freed, snapshot retained.
        Mechanically a ``pack``; the units come back ``PAUSED``."""
        from repro_torch.serving.workunit import PAUSED
        units = self.pack(slots)
        for u in units:
            u.state = PAUSED
        self.preemptions += len(units)
        return units

    def resume(self, units: List["WorkUnit"]):
        """Re-admit paused units (the other half of ``preempt``)."""
        from repro_torch.serving.workunit import PACKED
        for u in units:
            u.state = PACKED
        self.resumes += len(units)
        self.unpack(units)

    def drain_units(self) -> Tuple[List["WorkUnit"], List[Request]]:
        """Empty the engine: packed in-flight work + the untouched queue.
        Units still waiting in the restore queue ride along as they are
        (same objects, same uids)."""
        units = self.pack()
        units.extend(self._restore)
        self._restore = []
        queued, self._queue = self._queue, []
        return units, queued

    def pending_units(self) -> Tuple["WorkUnit", ...]:
        """Restore-queue units awaiting admission."""
        return tuple(self._restore)

    def checkpoint_units(self) -> List["WorkUnit"]:
        """NON-destructive checkpoint of every occupied slot.

        The slots keep decoding: the returned units hold a frozen copy of
        each request (``out_tokens`` truncated to checkpoint progress)
        plus the sampler's generator state (``get_state()``, a host read
        of its seed and offset), so a lost replica's work restores from
        its last checkpoint and re-decodes only the lost tail.  Unit
        identity is copied, not shared.
        """
        from repro_torch.serving.workunit import WorkUnit
        self._poll()
        occupied = [i for i, r in enumerate(self._slots) if r is not None]
        if not occupied:
            return []
        rng = self.sample.rng.get_state()
        units = []
        for slot, cols in zip(occupied, self._gather_slots(occupied)):
            req = self._slots[slot]
            frozen = dataclasses.replace(
                req, out_tokens=list(req.out_tokens))
            snap = SlotSnapshot(
                request=frozen,
                fed=int(self._fed[slot]),
                next_tok=int(self._next_tok_host[slot]),
                cache_len=int(self._fed[slot]),
                cache=cols,
                rng=rng.clone(),
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
    @staticmethod
    def _default_evict_key(u: "WorkUnit") -> Tuple:
        """Keep-preference order under a shrink: most urgent SLO class
        first (lowest priority number), then most progress, uid
        tiebreak."""
        prio = u.slo.priority if u.slo is not None else 1
        return (prio, -u.snapshot.fed, u.uid)

    def resize(self, *, batch_size: Optional[int] = None,
               decode_block: Optional[int] = None,
               kv_pool_blocks: Optional[int] = None,
               evict_key=None) -> List["WorkUnit"]:
        """In-place geometry change: repack every live slot through the
        canonical ``SlotSnapshot`` path and rebuild the decode state at
        the new ``(batch_size, kv_pool_blocks)``.

        Surviving slots re-admit through ``_install`` (ahead of the
        queue, re-blocked into the new pool, whose sink row is rebuilt
        with it) so their streams continue bit-identically; the sampler's
        generator object is carried across.  Slots that no longer fit
        come back as ``PAUSED`` units.  ``evict_key`` orders
        keep-preference (the default keeps the most urgent SLO classes).
        The decode loops and prefill closures of the old geometry are
        dropped.
        """
        from repro_torch.serving.workunit import PAUSED
        new_batch = self.batch if batch_size is None else int(batch_size)
        if new_batch < 1:
            raise ValueError(f"batch_size must be >= 1, got {new_batch}")
        if decode_block is not None:
            self.decode_block = max(int(decode_block), 1)
        new_pool = self.pool_blocks
        if kv_pool_blocks is not None:
            if self.cache_mode != "paged":
                raise ValueError(
                    "kv_pool_blocks only applies to cache_mode='paged'")
            new_pool = int(kv_pool_blocks)
            if new_pool < self.max_blocks:
                raise ValueError(
                    f"kv_pool_blocks={new_pool} cannot hold one full "
                    f"request ({self.max_blocks} blocks) — admission "
                    f"would wedge")
        elif self.cache_mode == "paged" and batch_size is not None:
            # the pool follows the lane count by default (the
            # dense-equivalent memory budget at the new width)
            new_pool = new_batch * self.max_blocks
        if new_batch == self.batch and new_pool == self.pool_blocks:
            return []              # decode_block-only change: no repack
        units = self.pack()        # polls + harvests completions first
        units.sort(key=evict_key or self._default_evict_key)
        keep: List["WorkUnit"] = []
        evicted: List["WorkUnit"] = []
        lanes, blocks_free = new_batch, new_pool
        for u in units:
            need = (self._blocks_needed(self._req_maxfed(u.snapshot.request))
                    if self.cache_mode == "paged" else 0)
            if lanes > 0 and need <= blocks_free:
                keep.append(u)
                lanes -= 1
                blocks_free -= need
            else:
                evicted.append(u)
        rng = self.sample.rng      # the same generator, carried across
        # the old geometry's buffers go before the new ones are allocated
        self.state = self.sample = self._prompt_buf = None
        self.batch = new_batch
        self.shape = ShapeConfig("serve", self.max_seq, new_batch, "decode")
        if self.cache_mode == "paged":
            self.pool_blocks = new_pool
            self.state = zoo.init_paged_decode_state(
                self.cfg, self.shape, self.block_size, new_pool, self.device)
            self._alloc = BlockAllocator(new_pool)
            self._tables = np.full((new_batch, self.max_blocks),
                                   new_pool, np.int32)
        else:
            self.state = zoo.init_decode_state(self.cfg, self.shape,
                                               fill_len=0,
                                               device=self.device)
        self.sample = zoo.init_sample_state(self.cfg, self.shape,
                                            device=self.device)
        self.sample.rng = rng
        self._prompt_buf = torch.zeros((new_batch, self.max_seq),
                                       dtype=torch.int32, device=self.device)
        self._loops.clear()
        self._prefills.clear()
        self._slots = [None] * new_batch
        self._unit_meta = {}
        self._fed = np.zeros(new_batch, np.int64)
        self._plen = np.ones(new_batch, np.int64)
        self._maxfed = np.zeros(new_batch, np.int64)
        self._next_tok_host = np.zeros(new_batch, np.int64)
        self._out_read = np.zeros(new_batch, np.int64)
        # survivors re-admit ahead of everything already waiting
        self._restore = keep + self._restore
        for u in evicted:
            u.state = PAUSED
        self.resizes += 1
        self.resize_evictions += len(evicted)
        self._admit()
        return evicted
