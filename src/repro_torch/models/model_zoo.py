"""Task-level model API for serving: prefill, serve step, decode loops.

Port of the serving half of ``repro.models.model_zoo`` for the dense
family.  ``lax.scan`` over layers is a Python loop; the ``n_steps`` scan
of the decode loop is a Python loop of device ops with no ``.item()``,
no ``.cpu()``, no truth value of a tensor and no boolean-mask indexing
inside it, so a decode window never waits for the host.

Caches are updated in place: a serve step, decode loop or prefill
mutates the state it is given and returns it.  The KV cache is bf16
whatever the compute dtype, as in the reference.  A paged pool holds one
sink row past its ``num_blocks`` live rows (see ``layers``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.schema import count_params, init_params

# Families whose prefill needs only ``tokens`` (no frames / patch embeds)
# and can therefore be bulk-prefilled by a serving engine.  The port runs
# the dense family only; the others raise where a family is dispatched.
BULK_PREFILL_FAMILIES = ("dense", "moe", "ssm", "hybrid")
# Causal-attention families ignore a padded tail (position i never attends
# to j > i), so a prompt chunk may be right-padded to a bucket size.
PAD_SAFE_FAMILIES = ("dense", "moe")


def _dense_only(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1)")


def init_serving_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights for ``cfg``, drawn on ``device`` from a seeded
    ``torch.Generator`` and laid out as ``convert`` lays them out.

    Leaves are drawn in float32 and stored in ``compute_dtype`` leaf by
    leaf (the values the reference's per-use cast of its float32 params
    would give), so a full-width model never holds a float32 copy."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    tree = init_params(T.model_schema(cfg), gen, dev, cfg.compute_dtype)
    return params_from_numpy(tree, cfg, dev)


def num_params(cfg: ModelConfig) -> int:
    return count_params(T.model_schema(cfg))


# ============================================================== serving
@dataclasses.dataclass
class DecodeState:
    """Dense decode state: cache {"k", "v"} of (L, B, S, KV, D) bf16."""
    cache: Dict[str, torch.Tensor]
    cache_len: torch.Tensor  # (B,) int32 filled positions


def init_decode_state(cfg: ModelConfig, shape: ShapeConfig,
                      fill_len: Optional[int] = None,
                      device="cuda") -> DecodeState:
    _dense_only(cfg)
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    kv = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    cache = {k: torch.zeros(kv, dtype=torch.bfloat16, device=dev)
             for k in ("k", "v")}
    fl = S - 1 if fill_len is None else fill_len
    return DecodeState(cache, torch.full((B,), fl, dtype=torch.int32,
                                         device=dev))


# -------------------------------------------------------------- prefill
def _decoder_prefill(params, tokens, cfg: ModelConfig):
    """tokens (B, S) -> (final hidden (B, S, d), per-layer bf16 k, v)."""
    h = T.embed_tokens(params, tokens, cfg)
    ks, vs = [], []
    for lp in params["layers"]:
        h, (k, v) = L.attention_block(lp["attn"], h, cfg, causal=True)
        h = L.swiglu_block(lp["mlp"], h, cfg)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    return h, ks, vs


def make_prefill(cfg: ModelConfig, shape: ShapeConfig):
    """Returns fn(params, batch) -> (last_logits, DecodeState)."""
    _dense_only(cfg)

    def prefill(params, batch):
        h, ks, vs = _decoder_prefill(params, batch["tokens"], cfg)
        logits = T.lm_logits(params, h[:, -1:], cfg)
        cache_len = torch.full((shape.global_batch,), shape.seq_len,
                               dtype=torch.int32, device=h.device)
        return logits, DecodeState({"k": torch.stack(ks),
                                    "v": torch.stack(vs)}, cache_len)

    return prefill


def make_bulk_prefill(cfg: ModelConfig, shape: ShapeConfig, chunk: int):
    """Chunked bulk prefill into one slot of a batched decode cache.

    Returns ``fn(params, state, tokens, slot, n_real) -> DecodeState``:
    prefills a ``(1, chunk)`` token buffer, writes the resulting cache
    columns into row ``slot`` (positions ``[0, chunk)``) and sets
    ``cache_len[slot] = n_real``.  ``slot`` and ``n_real`` are host ints.
    """
    _dense_only(cfg)

    def bulk_prefill(params, state: DecodeState, tokens, slot: int,
                     n_real: int):
        _, ks, vs = _decoder_prefill(params, tokens, cfg)
        for key, cols in (("k", ks), ("v", vs)):
            for i, col in enumerate(cols):   # col: (1, chunk, KV, D)
                state.cache[key][i, slot, :chunk] = col[0]
        state.cache_len[slot] = n_real
        return state

    return bulk_prefill


# ------------------------------------------------- sync-free decode loop
@dataclasses.dataclass
class SampleState:
    """Device-resident continuous-batching state for the decode hot loop.

    Everything the per-step control flow needs lives on the device, so a
    multi-step decode window performs zero device->host transfers; the
    host reconciles progress from its own exact projection and fetches
    ``out_buf`` only at completion/drain boundaries.
    """
    next_tok: torch.Tensor   # (B, 1) int32 — token each slot feeds next step
    active: torch.Tensor     # (B,)  int32 — slot occupied and not finished
    fed: torch.Tensor        # (B,)  int32 — prompt+generated tokens fed so far
    plen: torch.Tensor       # (B,)  int32 — prompt length
    maxfed: torch.Tensor     # (B,)  int32 — fed value at which the slot is done
    out_buf: torch.Tensor    # (B, S) int32 — generated tokens at index fed-plen
    rng: torch.Generator     # device generator for temperature sampling


def init_sample_state(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                      device="cuda") -> SampleState:
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len

    def z(*shp):
        return torch.zeros(shp, dtype=torch.int32, device=dev)

    return SampleState(next_tok=z(B, 1), active=z(B), fed=z(B),
                       plen=torch.ones(B, dtype=torch.int32, device=dev),
                       maxfed=z(B), out_buf=z(B, S),
                       rng=torch.Generator(dev).manual_seed(seed))


def make_decode_loop(cfg: ModelConfig, shape: ShapeConfig, n_steps: int,
                     temperature: float = 0.0,
                     eos_token: Optional[int] = None, serve_step=None):
    """Fused sample-and-advance decode: ``n_steps`` serve steps with the
    sampling and continuous-batching bookkeeping on the device.

    ``serve_step`` injects an alternative per-token step with the same
    calling convention (paged engines pass ``make_paged_serve_step``'s);
    the bookkeeping body treats the cache state opaquely, so dense and
    paged loops share it.

    Returns ``fn(params, state, SampleState, prompt_buf) -> (state,
    SampleState)``.  Greedy decoding takes the first maximum, as
    ``jnp.argmax`` does.  Temperature sampling is Gumbel-max with the
    sample state's own ``torch.Generator``: a categorical draw like the
    reference's, from another random stream (so cross-package parity is
    greedy only).
    """
    if serve_step is None:
        serve_step = make_serve_step(cfg, shape)
    S = shape.seq_len

    def decode_loop(params, state, s: SampleState, prompt_buf):
        for _ in range(n_steps):
            logits, state = serve_step(params, state, s.next_tok, s.active)
            last = logits[:, -1, :]
            if temperature > 0:
                u = torch.rand(last.shape, generator=s.rng,
                               device=last.device).clamp_(min=1e-20)
                sampled = torch.argmax(
                    last.float() / temperature - torch.log(-torch.log(u)),
                    dim=-1)
            else:
                sampled = torch.argmax(last, dim=-1)
            sampled = sampled.to(torch.int32)
            act = s.active > 0
            fed2 = s.fed + s.active
            generating = act & (fed2 >= s.plen)
            oi = (fed2 - s.plen).clamp(0, S - 1).long()[:, None]
            cur = s.out_buf.gather(1, oi)[:, 0]
            s.out_buf.scatter_(1, oi, torch.where(generating, sampled,
                                                  cur)[:, None])
            prompt_tok = prompt_buf.gather(
                1, fed2.clamp(0, S - 1).long()[:, None])[:, 0]
            nxt = torch.where(fed2 < s.plen, prompt_tok, sampled)
            next_tok = torch.where(act[:, None], nxt[:, None], s.next_tok)
            done = generating & (fed2 >= s.maxfed)
            if eos_token is not None:
                done = done | (generating & (sampled == eos_token))
            active = s.active * (1 - done.to(torch.int32))
            s = SampleState(next_tok, active, fed2, s.plen, s.maxfed,
                            s.out_buf, s.rng)
        return state, s

    return decode_loop


# -------------------------------------------------------------- decode
def make_serve_step(cfg: ModelConfig, shape: ShapeConfig):
    """Returns fn(params, DecodeState, tokens (B,1), active (B,)) ->
    (logits, DecodeState): one new token per sequence against a cache
    of ``shape.seq_len``."""
    _dense_only(cfg)

    def serve_step(params, state: DecodeState, tokens, active=None):
        if active is None:
            active = torch.ones(tokens.shape[0], dtype=torch.int32,
                                device=tokens.device)
        act = active.bool()
        h = T.embed_tokens(params, tokens, cfg)
        clen = state.cache_len
        for i, lp in enumerate(params["layers"]):
            h, _ = L.decode_attention(
                lp["attn"], h, cfg, cache_k=state.cache["k"][i],
                cache_v=state.cache["v"][i], cache_len=clen, active=act)
            h = L.swiglu_block(lp["mlp"], h, cfg)
        logits = T.lm_logits(params, h, cfg)
        return logits, DecodeState(state.cache, clen + active)

    return serve_step


# ============================================================ paged cache
@dataclasses.dataclass
class PagedDecodeState:
    """Decode state over a *paged* KV cache (vLLM-style block pool).

    KV leaves are one shared pool ``(L, num_blocks + 1, block_size, KV,
    D)``: ``num_blocks`` live rows plus the sink row.  Each lane
    addresses its logical positions through ``block_tables`` (B,
    max_blocks) of physical pool rows.  Unallocated table entries hold
    the sentinel ``num_blocks``: gathers clamp it (garbage always masked
    by kv_len / causality), writes land in the sink row, so stale tables
    never corrupt live blocks.
    """
    cache: Dict[str, torch.Tensor]
    cache_len: torch.Tensor     # (B,) filled positions
    block_tables: torch.Tensor  # (B, max_blocks) int32 physical pool rows


def init_paged_decode_state(cfg: ModelConfig, shape: ShapeConfig,
                            block_size: int, num_blocks: int,
                            device="cuda") -> PagedDecodeState:
    _dense_only(cfg)
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    if S % block_size:
        raise ValueError(f"seq_len {S} not a multiple of {block_size}")
    mb = S // block_size
    pool = (cfg.num_layers, num_blocks + 1, block_size, cfg.num_kv_heads,
            cfg.head_dim)
    cache = {k: torch.zeros(pool, dtype=torch.bfloat16, device=dev)
             for k in ("k", "v")}
    return PagedDecodeState(
        cache, torch.zeros(B, dtype=torch.int32, device=dev),
        torch.full((B, mb), num_blocks, dtype=torch.int32, device=dev))


def make_paged_serve_step(cfg: ModelConfig, shape: ShapeConfig,
                          block_size: int, num_blocks: int,
                          impl: str = "kernel"):
    """Paged ``make_serve_step``: fn(params, PagedDecodeState, tokens,
    active) -> (logits, PagedDecodeState).  Same sampling-visible math as
    the dense step; the attention core is the CUDA kernel on the card
    and the plain version on the CPU (or with ``impl="ref"``)."""
    _dense_only(cfg)

    def serve_step(params, state: PagedDecodeState, tokens, active=None):
        if active is None:
            active = torch.ones(tokens.shape[0], dtype=torch.int32,
                                device=tokens.device)
        act = active.bool()
        h = T.embed_tokens(params, tokens, cfg)
        clen, bt = state.cache_len, state.block_tables
        for i, lp in enumerate(params["layers"]):
            h, _ = L.paged_decode_attention(
                lp["attn"], h, cfg, pool_k=state.cache["k"][i],
                pool_v=state.cache["v"][i], block_tables=bt, cache_len=clen,
                active=act, impl=impl)
            h = L.swiglu_block(lp["mlp"], h, cfg)
        logits = T.lm_logits(params, h, cfg)
        return logits, PagedDecodeState(state.cache, clen + active, bt)

    return serve_step


def make_paged_decode_loop(cfg: ModelConfig, shape: ShapeConfig,
                           n_steps: int, block_size: int, num_blocks: int,
                           temperature: float = 0.0,
                           eos_token: Optional[int] = None):
    """``make_decode_loop`` over a paged cache — shares the exact
    sampling/bookkeeping body with the dense loop."""
    step = make_paged_serve_step(cfg, shape, block_size, num_blocks)
    return make_decode_loop(cfg, shape, n_steps, temperature=temperature,
                            eos_token=eos_token, serve_step=step)


def make_paged_bulk_prefill(cfg: ModelConfig, shape: ShapeConfig,
                            chunk: int, block_size: int, num_blocks: int,
                            first_chunk: bool = False):
    """State-continued chunk prefill into one slot of a paged cache.

    Returns ``fn(params, state, tokens, slot, off, n_real) ->
    PagedDecodeState``: prefills a ``(1, chunk)`` token buffer whose
    first token sits at absolute position ``off`` of slot ``slot``.
    Attention kv lands in the slot's blocks through its table; attention
    reads causally over history + chunk.  ``first_chunk=True`` is the
    ``off == 0`` specialization that skips the history gather.  Sets
    ``cache_len[slot] = off + n_real``.  ``slot``/``off``/``n_real`` are
    host ints.
    """
    _dense_only(cfg)

    def paged_prefill(params, state: PagedDecodeState, tokens, slot: int,
                      off: int, n_real: int):
        bt_row = state.block_tables[slot]
        h = T.embed_tokens(params, tokens, cfg)
        for i, lp in enumerate(params["layers"]):
            h, _, _ = L.paged_chunk_attention(
                lp["attn"], h, cfg, pool_k=state.cache["k"][i],
                pool_v=state.cache["v"][i], bt_row=bt_row, off=off,
                history=not first_chunk)
            h = L.swiglu_block(lp["mlp"], h, cfg)
        state.cache_len[slot] = off + n_real
        return state

    return paged_prefill
