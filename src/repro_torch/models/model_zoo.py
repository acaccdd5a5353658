"""Task-level model API for serving: prefill, serve step, decode loops.

Port of the serving half of ``repro.models.model_zoo`` for the dense,
ssm (mamba2) and hybrid (zamba2) families.  ``lax.scan`` over layers is
a Python loop; the ``n_steps`` scan of the decode loop is a Python loop
of device ops with no ``.item()``, no ``.cpu()``, no truth value of a
tensor and no boolean-mask indexing inside it, so a decode window never
waits for the host.

Caches are updated in place: a serve step, decode loop or prefill
mutates the state it is given and returns it.  The KV cache is bf16
whatever the compute dtype, as in the reference.  A paged pool holds one
sink row past its ``num_blocks`` live rows (see ``layers``).

Recurrent leaves, as the reference declares them: ``ssm`` (the SSD
state) is float32 and ``conv`` (the last W-1 pre-conv activations) is
bf16, ``(L, B, ...)`` for ssm and ``(periods, attn_every, B, ...)`` for
hybrid.  A step writes its new conv state into that bf16 leaf, in place:
in bf16 compute the value is already bf16, and in float32 compute this
is the rounding the reference's bf16 engine does.  The reference has no
multi-step float32 counterpart: its float32 ssm/hybrid engine stops at
the decode loop's carry check, whose conv leaf comes back float32
(ROADMAP §3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as ssm_lib
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.schema import count_params, init_params

# Families whose prefill needs only ``tokens`` (no frames / patch embeds)
# and can therefore be bulk-prefilled by a serving engine.  The port runs
# dense, ssm and hybrid; moe raises where a family is dispatched.
BULK_PREFILL_FAMILIES = ("dense", "moe", "ssm", "hybrid")
# Causal-attention families ignore a padded tail (position i never attends
# to j > i), so a prompt chunk may be right-padded to a bucket size.
# Recurrent families (ssm/hybrid) must never feed pad tokens through the
# state recurrence; their chunks are always fully real.
PAD_SAFE_FAMILIES = ("dense", "moe")
PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def _ported(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1)")


def paged_kv_keys(cfg: ModelConfig):
    """Cache keys stored in the block pool (vs. per-lane recurrent)."""
    _ported(cfg)
    return () if cfg.family == "ssm" else ("k", "v")


def _mamba_layers(params, cfg: ModelConfig):
    """The Mamba2 layers of one period (hybrid) or of the model (ssm):
    ``[(period or None, [(index, layer params), ...]), ...]``, where
    ``index`` addresses the recurrent leaves (``cache["ssm"][index]``)."""
    if cfg.family == "ssm":
        return [(None, [(i, lp) for i, lp in enumerate(params["layers"])])]
    return [(pi, [((pi, li), lp) for li, lp in enumerate(period)])
            for pi, period in enumerate(params["mamba"])]


def _recurrent_cache(cfg: ModelConfig, B: int, dev) -> Dict[str, torch.Tensor]:
    """Zeroed ``ssm`` (float32) and ``conv`` (bf16) leaves for B lanes."""
    _, nheads, conv_dim, _ = ssm_lib.mamba2_dims(cfg)
    lead = ((cfg.num_layers,) if cfg.family == "ssm"
            else (cfg.num_layers // cfg.attn_every, cfg.attn_every))
    return {
        "ssm": torch.zeros(lead + (B, nheads, cfg.ssm_head_dim,
                                   cfg.ssm_state),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros(lead + (B, cfg.conv_width - 1, conv_dim),
                            dtype=torch.bfloat16, device=dev)}


def lane_axis(cfg: ModelConfig) -> int:
    """The lane (batch) axis of the recurrent leaves."""
    return 1 if cfg.family == "ssm" else 2


def _attn_layers(cfg: ModelConfig) -> int:
    """Leading extent of the k/v leaves: layers (dense), periods (hybrid)."""
    return (cfg.num_layers if cfg.family == "dense"
            else cfg.num_layers // cfg.attn_every)


def init_serving_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights for ``cfg``, drawn on ``device`` from a seeded
    ``torch.Generator`` and laid out as ``convert`` lays them out.

    Leaves are drawn in float32 and stored in ``compute_dtype`` leaf by
    leaf (the values the reference's per-use cast of its float32 params
    would give), so a full-width model never holds a float32 copy; norms
    and Mamba2's ``A_log``/``dt_bias`` stay float32, as ``convert``
    keeps them."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    tree = init_params(T.model_schema(cfg), gen, dev, cfg.compute_dtype)
    return params_from_numpy(tree, cfg, dev)


def num_params(cfg: ModelConfig) -> int:
    return count_params(T.model_schema(cfg))


# ============================================================== serving
@dataclasses.dataclass
class DecodeState:
    """Dense decode state.  cache: {"k", "v"} of (L, B, S, KV, D) bf16
    (dense); {"ssm", "conv"} (ssm); both, k/v per period (hybrid)."""
    cache: Dict[str, torch.Tensor]
    cache_len: torch.Tensor  # (B,) int32 filled positions


def init_decode_state(cfg: ModelConfig, shape: ShapeConfig,
                      fill_len: Optional[int] = None,
                      device="cuda") -> DecodeState:
    _ported(cfg)
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    cache = {} if cfg.family == "dense" else _recurrent_cache(cfg, B, dev)
    if cfg.family != "ssm":
        kv = (_attn_layers(cfg), B, S, cfg.num_kv_heads, cfg.head_dim)
        cache.update({k: torch.zeros(kv, dtype=torch.bfloat16, device=dev)
                      for k in ("k", "v")})
    fl = S - 1 if fill_len is None else fill_len
    return DecodeState(cache, torch.full((B,), fl, dtype=torch.int32,
                                         device=dev))


# -------------------------------------------------------------- prefill
def _decoder_prefill(params, tokens, cfg: ModelConfig, impl: str = "kernel"):
    """tokens (B, S) -> (final hidden (B, S, d), per-layer bf16 k, v)."""
    h = T.embed_tokens(params, tokens, cfg)
    ks, vs = [], []
    for lp in params["layers"]:
        h, (k, v) = L.attention_block(lp["attn"], h, cfg, causal=True,
                                      impl=impl)
        h = L.swiglu_block(lp["mlp"], h, cfg)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    return h, ks, vs


def _ssm_prefill(params, tokens, cfg: ModelConfig, impl: str = "kernel"):
    """tokens (B, S) -> (final hidden, cache): per-layer SSD states
    (float32) and conv tails (bf16), stacked as the cache leaves are, and
    for hybrid the shared block's bf16 k, v per period."""
    h = T.embed_tokens(params, tokens, cfg)
    shared = params.get("shared")
    sts, convs, ks, vs = [], [], [], []
    for _, layers in _mamba_layers(params, cfg):
        for _, lp in layers:
            h, (st, conv) = ssm_lib.mamba2_block(lp, h, cfg, impl=impl)
            sts.append(st.float())
            convs.append(conv.to(torch.bfloat16))
        if shared is not None:
            h, (k, v) = L.attention_block(shared["attn"], h, cfg,
                                          causal=True, impl=impl)
            h = L.swiglu_block(shared["mlp"], h, cfg)
            ks.append(k.to(torch.bfloat16))
            vs.append(v.to(torch.bfloat16))
    lead = ((cfg.num_layers,) if cfg.family == "ssm"
            else (len(ks), cfg.attn_every))
    cache = {"ssm": torch.stack(sts).reshape(lead + sts[0].shape),
             "conv": torch.stack(convs).reshape(lead + convs[0].shape)}
    if shared is not None:
        cache.update(k=torch.stack(ks), v=torch.stack(vs))
    return h, cache


def make_prefill(cfg: ModelConfig, shape: ShapeConfig, impl: str = "kernel"):
    """Returns fn(params, batch) -> (last_logits, DecodeState).

    Past 8192 tokens (or with ``cfg.attn_impl="blockwise"``) attention is
    ``blockwise_attention``: the flash-attention kernel on the card.
    Every kernel on the way (flash attention, SSD) runs its plain version
    on the CPU, or with ``impl="ref"``."""
    _ported(cfg)

    def prefill(params, batch):
        if cfg.family == "dense":
            h, ks, vs = _decoder_prefill(params, batch["tokens"], cfg, impl)
            cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        else:
            h, cache = _ssm_prefill(params, batch["tokens"], cfg, impl)
        logits = T.lm_logits(params, h[:, -1:], cfg)
        cache_len = torch.full((shape.global_batch,), shape.seq_len,
                               dtype=torch.int32, device=h.device)
        return logits, DecodeState(cache, cache_len)

    return prefill


def make_bulk_prefill(cfg: ModelConfig, shape: ShapeConfig, chunk: int,
                      impl: str = "kernel"):
    """Chunked bulk prefill into one slot of a batched decode cache.

    Returns ``fn(params, state, tokens, slot, n_real) -> DecodeState``:
    prefills a ``(1, chunk)`` token buffer, writes the resulting cache
    columns into row ``slot`` (positions ``[0, chunk)`` of k/v; whole-row
    replacement of the recurrent ssm/conv leaves) and sets
    ``cache_len[slot] = n_real``.  ``slot`` and ``n_real`` are host ints.
    A chunk past 8192 tokens runs the flash-attention kernel on the card
    (``make_prefill``; ``impl="ref"``: the plain versions).
    """
    _ported(cfg)
    prefill = make_prefill(cfg, ShapeConfig(f"prefill_chunk{chunk}", chunk,
                                            1, "prefill"), impl)

    def bulk_prefill(params, state: DecodeState, tokens, slot: int,
                     n_real: int):
        _, pstate = prefill(params, {"tokens": tokens})
        for key, upd in pstate.cache.items():
            leaf = state.cache[key]
            if key in ("k", "v"):            # (L, 1, chunk, KV, D)
                leaf[:, slot, :chunk] = upd[:, 0]
            else:
                ax = lane_axis(cfg)
                leaf.select(ax, slot).copy_(upd.select(ax, 0))
        state.cache_len[slot].fill_(n_real)
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
def _layer_stack(params, cache, h, cfg: ModelConfig, attention, *,
                 act=None, slot: Optional[int] = None, fresh: bool = False,
                 impl: str = "kernel"):
    """The model's layers over ``h``, caches updated in place.  Every
    attention is ``attention(attn params, h, index of its k/v leaves) ->
    h``: each dense layer's, and the hybrid shared block's at the end of
    each period.

    Mamba2 layers, decode (``slot`` None): one token per lane, each layer
    steps its lanes' states (lanes with ``act`` False keep theirs).  Chunk
    prefill (``slot`` given): the chunk continues lane ``slot``'s states,
    or starts from zeros when ``fresh``, and they are replaced whole.
    """
    if cfg.family == "dense":
        for i, lp in enumerate(params["layers"]):
            h = attention(lp["attn"], h, i)
            h = L.swiglu_block(lp["mlp"], h, cfg)
        return h
    shared = params.get("shared")
    for period, layers in _mamba_layers(params, cfg):
        for idx, lp in layers:
            ssm, conv = cache["ssm"][idx], cache["conv"][idx]  # (B, ...)
            if slot is None:
                h, (st, cv) = ssm_lib.mamba2_block(
                    lp, h, cfg, ssm_state=ssm, conv_state=conv, active=act)
            else:
                ssm, conv = ssm[slot:slot + 1], conv[slot:slot + 1]
                h, (st, cv) = ssm_lib.mamba2_block(
                    lp, h, cfg, impl=impl,
                    init_ssm=None if fresh else ssm,
                    init_conv=None if fresh else conv)
            ssm.copy_(st)
            conv.copy_(cv)
        if shared is not None:
            h = attention(shared["attn"], h, period)
            h = L.swiglu_block(shared["mlp"], h, cfg)
    return h


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig):
    """Returns fn(params, DecodeState, tokens (B,1), active (B,)) ->
    (logits, DecodeState): one new token per sequence against a cache
    of ``shape.seq_len``."""
    _ported(cfg)

    def serve_step(params, state: DecodeState, tokens, active=None):
        if active is None:
            active = torch.ones(tokens.shape[0], dtype=torch.int32,
                                device=tokens.device)
        act = active.bool()
        h = T.embed_tokens(params, tokens, cfg)
        cache, clen = state.cache, state.cache_len

        def attention(p, x, i):
            x, _ = L.decode_attention(p, x, cfg, cache_k=cache["k"][i],
                                      cache_v=cache["v"][i], cache_len=clen,
                                      active=act)
            return x

        h = _layer_stack(params, cache, h, cfg, attention, act=act)
        logits = T.lm_logits(params, h, cfg)
        return logits, DecodeState(cache, clen + active)

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
    never corrupt live blocks.  Hybrid has one pool per period, ssm none;
    their recurrent leaves (ssm/conv) stay lane-indexed.
    """
    cache: Dict[str, torch.Tensor]
    cache_len: torch.Tensor     # (B,) filled positions
    block_tables: torch.Tensor  # (B, max_blocks) int32 physical pool rows


def init_paged_decode_state(cfg: ModelConfig, shape: ShapeConfig,
                            block_size: int, num_blocks: int,
                            device="cuda") -> PagedDecodeState:
    _ported(cfg)
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    if S % block_size:
        raise ValueError(f"seq_len {S} not a multiple of {block_size}")
    mb = S // block_size
    cache = {} if cfg.family == "dense" else _recurrent_cache(cfg, B, dev)
    for key in paged_kv_keys(cfg):
        cache[key] = torch.zeros(
            (_attn_layers(cfg), num_blocks + 1, block_size,
             cfg.num_kv_heads, cfg.head_dim), dtype=torch.bfloat16,
            device=dev)
    return PagedDecodeState(
        cache, torch.zeros(B, dtype=torch.int32, device=dev),
        torch.full((B, mb), num_blocks, dtype=torch.int32, device=dev))


def make_paged_serve_step(cfg: ModelConfig, shape: ShapeConfig,
                          block_size: int, num_blocks: int,
                          impl: str = "kernel"):
    """Paged ``make_serve_step``: fn(params, PagedDecodeState, tokens,
    active) -> (logits, PagedDecodeState).  Same sampling-visible math as
    the dense step; the attention core is the CUDA kernel on the card
    and the plain version on the CPU (or with ``impl="ref"``).  In the
    hybrid family the shared block's attention is the step's only one."""
    _ported(cfg)

    def serve_step(params, state: PagedDecodeState, tokens, active=None):
        if active is None:
            active = torch.ones(tokens.shape[0], dtype=torch.int32,
                                device=tokens.device)
        act = active.bool()
        h = T.embed_tokens(params, tokens, cfg)
        cache, clen, bt = state.cache, state.cache_len, state.block_tables

        def attention(p, x, i):
            x, _ = L.paged_decode_attention(
                p, x, cfg, pool_k=cache["k"][i], pool_v=cache["v"][i],
                block_tables=bt, cache_len=clen, active=act, impl=impl)
            return x

        h = _layer_stack(params, cache, h, cfg, attention, act=act)
        logits = T.lm_logits(params, h, cfg)
        return logits, PagedDecodeState(cache, clen + active, bt)

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
                            first_chunk: bool = False, impl: str = "kernel"):
    """State-continued chunk prefill into one slot of a paged cache.

    Returns ``fn(params, state, tokens, slot, off, n_real) ->
    PagedDecodeState``: prefills a ``(1, chunk)`` token buffer whose
    first token sits at absolute position ``off`` of slot ``slot``.
    Attention kv lands in the slot's blocks through its table; attention
    reads causally over history + chunk.  Recurrent (ssm/conv) leaves
    continue from the slot's carried state — zeros when ``off == 0`` —
    through the SSD ``init_state``: exactly one long prefill over the
    concatenated chunks.  The SSD core is the CUDA kernel on the card and
    the plain version on the CPU (or with ``impl="ref"``).
    ``first_chunk=True`` is the ``off == 0`` specialization that skips
    the history gather.  Sets ``cache_len[slot] = off + n_real``.
    ``slot``/``off``/``n_real`` are host ints, so the ``off == 0`` choice
    is a Python branch with no sync.
    """
    _ported(cfg)

    def paged_prefill(params, state: PagedDecodeState, tokens, slot: int,
                      off: int, n_real: int):
        bt_row = state.block_tables[slot]
        cache = state.cache
        h = T.embed_tokens(params, tokens, cfg)

        def attention(p, x, i):
            x, _, _ = L.paged_chunk_attention(
                p, x, cfg, pool_k=cache["k"][i], pool_v=cache["v"][i],
                bt_row=bt_row, off=off, history=not first_chunk)
            return x

        _layer_stack(params, cache, h, cfg, attention, slot=slot,
                     fresh=first_chunk or off == 0, impl=impl)
        state.cache_len[slot].fill_(off + n_real)
        return state

    return paged_prefill
