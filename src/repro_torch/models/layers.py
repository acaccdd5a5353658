"""Shared neural building blocks: norms, rotary, attention, MLPs.

Port of ``repro.models.layers``.  Params are per-layer dicts of tensors
(``models.convert``): matmul weights already in compute dtype, norm
weights float32.

JAX's implicit index rules are explicit here:

* out-of-range gathers clamp (``clamp`` on the index);
* out-of-range ``.at[].set(mode="drop")`` writes land in a **sink row**:
  a paged pool holds ``num_blocks + 1`` rows, and row ``num_blocks``
  (the table sentinel) is written by sentinel and inactive-lane writes
  and never read as live data.  Clamping a sentinel to ``num_blocks - 1``
  instead would alias a live block of another lane, and duplicate
  indices in one ``index_copy_`` have no defined order, so only the sink
  row ever receives duplicates;
* masking never uses a boolean index (that syncs with the host).

Cache and pool updates are in place (``index_copy_`` into the caller's
tensors), where the reference returns updated copies: the functions still
return the (mutated) cache tensors so the call sites read the same.

Under sharding rules with a model axis above 1 (training over a
``("data", "model")`` mesh), ``attention_block`` and ``swiglu_block``
are tensor parallel, the counterparts of the reference's constraints at
``layers.py:166, 198, 200, 357, 359``: each model rank holds its
contiguous block of ``heads``, ``kv_heads`` and ``ff`` where the rules
shard them, q/k/v and gate/up are column-parallel after
``copy_to_model`` (f), and ``wo`` / ``w_down`` row-parallel, their
partial sums all-reduced in the block's dtype (``reduce_from_model``,
g).  Contiguous head blocks keep GQA local (query head ``h`` reads KV
head ``h // group`` on the same rank).  Where the rules replicate
``kv_heads`` while they shard ``heads``, a rank holds all KV heads and
reads those its query heads need.  A dimension the rules replicate is
computed whole, with no collective.

Serving over such a mesh keeps the reference's decode state.  Where
``m`` divides the cache's positions a rank holds its ``S / m``
positions of every KV head (``cache_seq`` over ``model``): a prefill's
blocks are the training path's, and ``cache_block`` cuts the cache's
positions from their k and v; a decode step (``decode_attention`` under
the rules) is a split softmax over the ranks' positions
(``block_logits``, ``block_stats``, ``merge_stats``,
``block_attention``, ``seq_sharded_attention``).  Where it does not, a
rank holds every position of its KV heads (``kv_heads`` over ``model``
where they divide, else all of them), and a step is the training
path's tensor-parallel attention over them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import dtype_of
from repro_torch.launch.sharding import (all_reduce, cache_seq_split,
                                         copy_to_model, gather_over_model,
                                         gather_parts, model_axis,
                                         model_split, position_owner,
                                         reduce_from_model)

NEG_INF = -1e30


# ----------------------------------------------------------------------------- norms
def rms_norm(x, weight, eps: float):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


# ----------------------------------------------------------------------------- rotary
def rotary_embedding(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> (cos, sin) of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------- projections
def _proj(h, w):
    """(B, S, d) x (d, H, D) -> (B, S, H, D): ``einsum('bsd,dhk->bshk')``."""
    d, nh, hd = w.shape
    return torch.matmul(h, w.reshape(d, nh * hd)).reshape(
        *h.shape[:-1], nh, hd)


def _proj_out(o, w):
    """(B, S, H, D) x (H, D, d) -> (B, S, d): ``einsum('bshk,hkd->bsd')``."""
    nh, hd, d = w.shape
    return torch.matmul(o.reshape(*o.shape[:-2], nh * hd),
                        w.reshape(nh * hd, d))


def _qkv(p, x, cfg):
    dt = dtype_of(cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    return _proj(h, p["wq"]), _proj(h, p["wk"]), _proj(h, p["wv"])


def kv_index(cfg, device):
    """The KV head each of this model rank's query heads reads, as an
    index into the KV heads it holds, where the active rules shard
    ``heads`` over a model axis and replicate ``kv_heads`` (the rank
    holds every KV head); ``None`` where its KV heads are its query
    heads' own (a block of them, GQA local) or where no rule shards
    ``heads``."""
    if model_split("heads", cfg.num_heads) == 1 or \
            model_split("kv_heads", cfg.num_kv_heads) > 1:
        return None
    tp = model_axis()
    group = cfg.num_heads // cfg.num_kv_heads
    n = cfg.num_heads // tp.size
    return (tp.rank * n + torch.arange(n, device=device)) // group


def kv_heads_tp(p, h, cfg):
    """k, v (B, S, heads, D) of the KV heads this model rank holds, from
    ``h`` (B, S, d), which has been through f (``copy_to_model``), and
    the KV head each of its query heads reads (``kv_index``): its block
    of them (``kv_heads`` sharded; ``None``, GQA stays local), or, where
    the rules replicate them, all of them and the index of its query
    heads' KV heads among them."""
    heads = kv_index(cfg, h.device)
    if heads is None:
        return _proj(h, p["wk"]), _proj(h, p["wv"]), None
    # all KV heads on every rank: their weights' gradients are partial
    # (each rank reads some heads), so f sums them over the ranks
    return (_proj(h, copy_to_model(p["wk"])),
            _proj(h, copy_to_model(p["wv"])), heads)


def expand_kv(k, v, heads):
    """``kv_heads_tp``'s k, v -> those of each of the rank's query heads
    (``heads`` None: as they are)."""
    if heads is None:
        return k, v
    return k.index_select(2, heads), v.index_select(2, heads)


def cache_block(k, cfg):
    """The decode state's block of a prefill's k or v (B_r, S, heads, D),
    the KV heads this model rank holds (``kv_heads_tp``), under rules
    with a model axis ``m`` above 1: where ``m`` divides the cache's
    positions (``cache_seq_split``), the reference's layout, ``cache_seq``
    over ``model`` and every KV head a rank, so the rank's ``S / m``
    positions of every KV head (an all-gather over the model group where
    the rules shard ``kv_heads``, then a slice; a slice alone where each
    rank holds every KV head).  Otherwise ``k`` itself: every position
    of the KV heads the rank holds, its block of them where the rules
    shard ``kv_heads`` (the reference gives them ``model`` then) and all
    of them where they do not (the cache whole on every rank)."""
    if not cache_seq_split():
        return k
    tp = model_axis()
    if model_split("kv_heads", cfg.num_kv_heads) > 1:
        k = gather_over_model(k, 2)
    n = k.shape[1] // tp.size
    return k.narrow(1, tp.rank * n, n)


# ----------------------------------------------------------------------------- attention cores
def full_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                   kv_len=None):
    """Reference full attention with GQA. q:(B,Sq,H,D), k/v:(B,Sk,KV,D).

    ``q_offset`` is the absolute position of q[0] (for decode).
    ``kv_len`` optionally masks out cache positions >= kv_len.

    Logits are float32 from operands in their own dtype: bf16 values are
    upcast before the product, which is exact (a product of two bf16
    values fits float32), so this is the reference's bf16-operand,
    float32-accumulation einsum.  Plain tensor ops, as XLA's is in the
    reference; it is not a kernel.
    """
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)       # (B,Sq,KV,G,D)
    scale = d ** -0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    sk = k.shape[1]
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]   # (Sq, Sk)
        logits = torch.where(mask, logits, NEG_INF)
    if kv_len is not None:
        valid = (torch.arange(sk, device=q.device)[None, :]
                 < kv_len[:, None])             # (B, Sk)
        logits = torch.where(valid[:, None, None, None], logits, NEG_INF)
    # jax.nn.softmax's own formula: exp(x - max) / sum
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def attention_blocks(sq: int, sk: int, block_q: int, block_kv: int):
    """The blockwise contract: ``(min(block_q, sq), min(block_kv, sk))``,
    which must divide ``sq`` and ``sk`` (the reference asserts it);
    ``ValueError`` otherwise."""
    bq, bkv = min(block_q, sq), min(block_kv, sk)
    if bq <= 0 or bkv <= 0 or sq % bq or sk % bkv:
        raise ValueError(f"blocks ({block_q}, {block_kv}) must be positive "
                         f"and, cut to the lengths ({sq}, {sk}), divide "
                         f"them")
    return bq, bkv


def blockwise_attention(q, k, v, *, causal: bool, block_q: int,
                        block_kv: int, impl: str = "kernel"):
    """Memory-O(S*block) attention (online softmax), the prefill path past
    8192 tokens.  q: (B, Sq, H, D); k/v: (B, Sk, KV, D) -> (B, Sq, H, D).

    On a CUDA tensor this is the flash-attention kernel
    (``kernels.flash_attention.ops.attention``), which computes the same
    function.  On a CPU tensor, or with ``impl="ref"``, it is the plain
    form of ``repro/models/layers.py:85-146`` transcribed: for each q
    block an online softmax from ``m = -inf`` over the kv blocks below
    the causal bound ``n_valid`` (the index clamped to the last block, as
    ``dynamic_index_in_dim`` clamps it), ``p`` rounded to v's dtype
    before ``p @ v`` with float32 accumulation, output
    ``acc / max(l, 1e-30)``.  In bf16 that rounding is where the plain
    form and the kernel (which keeps ``p`` in float32) differ."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "kernel" and q.device.type != "cpu":
        from repro_torch.kernels.flash_attention import attention
        return attention(q, k, v, causal=causal, block_q=block_q,
                         block_kv=block_kv)
    b, sq, h, d = q.shape
    kv_heads, sk = k.shape[2], k.shape[1]
    g = h // kv_heads
    block_q, block_kv = attention_blocks(sq, sk, block_q, block_kv)
    nq, nk = sq // block_q, sk // block_kv
    scale = d ** -0.5
    dev = q.device
    qr = q.reshape(b, nq, block_q, kv_heads, g, d).float()
    kr = k.reshape(b, nk, block_kv, kv_heads, d).float()
    vr = v.reshape(b, nk, block_kv, kv_heads, d)
    outs = []
    for iq in range(nq):
        qi = qr[:, iq]
        qpos = iq * block_q + torch.arange(block_q, device=dev)
        acc = torch.zeros((b, kv_heads, g, block_q, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, kv_heads, g, block_q), -torch.inf,
                       dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        n_valid = (((iq + 1) * block_q + block_kv - 1) // block_kv
                   if causal else nk)
        for ik in range(n_valid):
            ki, vi = kr[:, min(ik, nk - 1)], vr[:, min(ik, nk - 1)]
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, ki) * scale
            if causal:
                kpos = ik * block_kv + torch.arange(block_kv, device=dev)
                s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vi.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=3)               # (B, KV, G, nq, bq, D)
    out = out.reshape(b, kv_heads, g, sq, d).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, h, d).to(q.dtype)


# ----------------------------------------------------------------------------- attention layer
def attention_block(p, x, cfg, *, causal=True, positions=None,
                    impl: str = "kernel"):
    """Pre-norm attention block with rotary + GQA, prefill mode: attends
    within ``x`` and returns ``(out, (k, v))``, k and v of the KV heads
    the model rank holds (``kv_heads_tp``; all of them on one device).

    The attention core is the reference's choice: ``cfg.attn_impl``, with
    ``"auto"`` taking ``blockwise_attention`` for ``s > 8192`` and
    ``full_attention`` otherwise.  ``impl`` goes to
    ``blockwise_attention`` (``"ref"``: its plain form on the card)."""
    b, s, _ = x.shape
    tp = model_split("heads", cfg.num_heads) > 1
    heads = None
    if tp:
        dt = dtype_of(cfg.compute_dtype)
        h = copy_to_model(rms_norm(x, p["norm"], cfg.norm_eps).to(dt))
        q = _proj(h, p["wq"])
        k, v, heads = kv_heads_tp(p, h, cfg)
    else:
        q, k, v = _qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    kq, vq = expand_kv(k, v, heads)
    attn = cfg.attn_impl
    if attn == "auto":
        attn = "blockwise" if s > 8192 else "full"
    if attn == "blockwise":
        out = blockwise_attention(q, kq, vq, causal=causal,
                                  block_q=cfg.flash_block_q,
                                  block_kv=cfg.flash_block_kv, impl=impl)
    else:
        out = full_attention(q, kq, vq, causal=causal)
    out = _proj_out(out, p["wo"])
    return x + (reduce_from_model(out) if tp else out), (k, v)


def decode_attention(p, x, cfg, *, cache_k, cache_v, cache_len,
                     active=None):
    """One-token decode against a KV cache.

    cache_k/v: (B, S_max, KV, D); cache_len: (B,) current lengths.
    Writes the new token at ``cache_len`` in place and returns
    ``(out, (cache_k, cache_v))``.  Inactive lanes and lanes with
    ``cache_len == S_max`` write back the value already at the clamped
    position (the reference keeps the old value and drops the write);
    each lane writes its own row, so no two writes collide.

    Under rules with a model axis above 1 the cache is this rank's block
    of the reference's layout.  Where the axis divides the cache's
    positions (``sharding.cache_seq_split``) that is ``cache_seq`` over
    ``model``, every KV head, and the step is
    ``_decode_attention_split``'s.  Otherwise the rank holds every
    position of its KV heads (its block of them where the rules shard
    ``kv_heads``, all of them where they do not), and the step is the
    training path's tensor-parallel attention (``attention_block``):
    q of its query heads, k and v of its KV heads (``kv_heads_tp``),
    every rank writes its KV heads' new token, ``full_attention`` over
    every position, ``wo`` row-parallel and g; where the rules replicate
    ``heads``, the one-device step on every rank.
    """
    if cache_seq_split():
        return _decode_attention_split(p, x, cfg, cache_k=cache_k,
                                       cache_v=cache_v, cache_len=cache_len,
                                       active=active)
    dt = dtype_of(cfg.compute_dtype)
    tp = model_split("heads", cfg.num_heads) > 1
    heads = None
    if tp:
        h = copy_to_model(rms_norm(x, p["norm"], cfg.norm_eps).to(dt))
        q = _proj(h, p["wq"])
        k, v, heads = kv_heads_tp(p, h, cfg)
    else:
        q, k, v = _qkv(p, x, cfg)
    cos, sin = rotary_embedding(cache_len[:, None], cfg.head_dim,
                                cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    _write_token(cache_k, cache_v, k, v, cache_len, active)
    out = full_attention(q, *expand_kv(cache_k.to(dt), cache_v.to(dt),
                                       heads),
                         causal=False, kv_len=cache_len + 1)
    out = _proj_out(out, p["wo"])
    return x + (reduce_from_model(out) if tp else out), (cache_k, cache_v)


def _write_token(cache_k, cache_v, k, v, cache_len, active, rank: int = 0,
                 ranks: int = 1):
    """Each lane's new k, v (B, 1, KV, D) into model rank ``rank``'s block
    of a cache cut in ``ranks`` position blocks (``S_blk`` positions
    each), in place, at ``cache_len - rank S_blk`` where the rank owns
    position ``cache_len`` (``position_owner``) and the lane is active;
    every other lane writes back the value at its clamped position."""
    b, S = cache_k.shape[:2]
    pos = cache_len.long() - rank * S
    write = position_owner(cache_len.long(), S * ranks, ranks) == rank
    if active is not None:
        write = write & active
    flat = torch.arange(b, device=k.device) * S + pos.clamp(0, S - 1)
    for cache, new in ((cache_k, k), (cache_v, v)):
        rows = cache.view(b * S, *cache.shape[2:])
        old = rows.index_select(0, flat)
        rows.index_copy_(0, flat, torch.where(
            write[:, None, None], new[:, 0].to(cache.dtype), old))


def block_logits(q, k, *, lo: int = 0, kv_len=None):
    """``full_attention``'s float32 logits (B, KV, G, Sq, S_blk) of q (B,
    Sq, H, D) over a block k (B, S_blk, KV, D) holding the positions
    ``[lo, lo + S_blk)``, those at or past ``kv_len`` (B,) masked to
    ``NEG_INF``."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * \
        d ** -0.5
    if kv_len is not None:
        valid = (lo + torch.arange(k.shape[1], device=q.device)[None, :]
                 < kv_len[:, None])
        logits = torch.where(valid[:, None, None, None], logits, NEG_INF)
    return logits


def block_stats(logits):
    """A block's softmax statistics from its ``block_logits``: m its
    largest logit (B, KV, G, Sq) and l its sum of ``exp(logit - m)``."""
    m = logits.amax(dim=-1)
    return m, torch.exp(logits - m[..., None]).sum(dim=-1)


def merge_stats(m, l):
    """Blocks' softmax statistics stacked on a leading axis of blocks, m
    each block's largest logit (B, KV, G, Sq) and l its sum of
    ``exp(logit - m)`` -> the whole sequence's: the largest logit and
    the sum ``sum_r exp(m_r - max m) l_r``.  A block with no valid
    position (``m_r = NEG_INF``: its ``l`` counts every position) adds
    nothing, since its weight is ``exp(NEG_INF - max m) = 0`` while some
    block holds a valid position."""
    mx = m.amax(dim=0)
    return mx, (torch.exp(m - mx) * l).sum(0)


def block_attention(logits, mx, den, v):
    """A block's share of ``full_attention``'s output (B, KV, G, Sq, D)
    float32, from its ``block_logits`` and the whole sequence's
    ``merge_stats``: the probabilities ``exp(logit - mx) / den``
    rounded to v's dtype, as ``full_attention`` rounds them, times the
    block's v.  The blocks' shares sum to ``full_attention`` (its
    denominator summed in another order)."""
    probs = torch.exp(logits - mx[..., None]) / den[..., None]
    return torch.einsum("bkgqs,bskd->bkgqd", probs.to(v.dtype).float(),
                        v.float())


def seq_sharded_attention(q, k, v, *, kv_len=None):
    """Attention of q (B, Sq, H, D), every query head, over a key/value
    sequence cut in blocks over the model ranks (this rank's k/v (B,
    S_blk, KV, D) hold positions ``[r S_blk, (r+1) S_blk)``), those at or
    past ``kv_len`` masked: each rank's ``block_logits`` and their
    ``block_stats``, all-gathered over the model group (``merge_stats``),
    then each rank's ``block_attention`` summed over the group (an
    all-reduce).  (B, Sq, H, D) float32, the same on every rank."""
    tp = model_axis()
    b, sq, h, d = q.shape
    logits = block_logits(q, k, lo=tp.rank * k.shape[1], kv_len=kv_len)
    s = torch.stack(gather_parts(torch.stack(block_stats(logits), -1),
                                 tp.group, tp.size))
    mx, den = merge_stats(s[..., 0], s[..., 1])
    out = all_reduce(block_attention(logits, mx, den, v), tp.group)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)


def _decode_attention_split(p, x, cfg, *, cache_k, cache_v, cache_len,
                            active):
    """``decode_attention`` over the reference's sequence-sharded cache:
    this model rank holds positions ``[r S/m, (r+1) S/m)`` of every KV
    head (``cache_k``/``cache_v`` (B, S/m, KV, D)) and its block of the
    query heads, KV heads and ``wo`` where the rules shard them.

    1. q of the rank's query heads (f on the normed input), k and v of
       its KV heads (``kv_heads_tp``: its block, or all of them);
    2. every query head's q and every KV head's k, v on every rank: one
       all-gather over the model group of what the rules shard (none
       where both are replicated), then rotary at ``cache_len``;
    3. the rank that owns position ``cache_len`` of a lane writes it
       (``_write_token``: inactive lanes and ``cache_len == S`` write
       nothing, as on one device);
    4. ``seq_sharded_attention`` with ``kv_len = cache_len + 1``, the
       reference's mask: a split softmax, its statistics merged by
       log-sum-exp, its probabilities rounded as on one device;
    5. the rank's query heads through ``wo`` (row-parallel) and g, or
       every head through the whole ``wo`` where ``heads`` is
       replicated.  Returns ``(out, (cache_k, cache_v))``."""
    tp = model_axis()
    dt = dtype_of(cfg.compute_dtype)
    tp_heads = model_split("heads", cfg.num_heads) > 1
    if tp_heads:
        h = copy_to_model(rms_norm(x, p["norm"], cfg.norm_eps).to(dt))
        q = _proj(h, p["wq"])
        k, v, _ = kv_heads_tp(p, h, cfg)
        # every head on every rank: q, and k, v where the rules split them
        parts = (q, k, v) if k.shape[2] < cfg.num_kv_heads else (q,)
        sizes = [t.shape[2] for t in parts]
        blocks = [g.split(sizes, 2) for g in gather_parts(
            torch.cat(parts, 2), tp.group, tp.size)]
        q, *kv = (torch.cat(ts, 2) for ts in zip(*blocks))
        k, v = kv or (k, v)
    else:
        q, k, v = _qkv(p, x, cfg)
    cos, sin = rotary_embedding(cache_len[:, None], cfg.head_dim,
                                cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    _write_token(cache_k, cache_v, k, v, cache_len, active, tp.rank,
                 tp.size)
    out = seq_sharded_attention(q, cache_k.to(dt), cache_v.to(dt),
                                kv_len=cache_len + 1).to(dt)
    if not tp_heads:
        return x + _proj_out(out, p["wo"]), (cache_k, cache_v)
    n = cfg.num_heads // tp.size
    out = _proj_out(out.narrow(2, tp.rank * n, n), p["wo"])
    return x + reduce_from_model(out), (cache_k, cache_v)


def _drop_to_sink(rows, nb: int):
    """Pool rows of a write: entries outside ``[0, nb)`` -> sink row nb."""
    return torch.where((rows >= 0) & (rows < nb), rows, nb).long()


def paged_decode_attention(p, x, cfg, *, pool_k, pool_v, block_tables,
                           cache_len, active=None, impl: str = "kernel"):
    """One-token decode against a *paged* KV cache (block pool + tables).

    pool_k/v: (num_blocks + 1, bs, KV, D) — one shared pool plus the sink
    row; each lane's logical positions map through block_tables
    (B, max_blocks) to physical pool rows.  Writes the new kv at logical
    position ``cache_len`` (physical: block ``bt[b, cache_len // bs]``,
    the column clamped to ``max_blocks - 1`` as JAX clamps the read;
    offset ``cache_len % bs``).  Inactive lanes and sentinel entries
    write into the sink row.  The attention core is
    ``kernels.paged_attention`` over the ``num_blocks`` live rows: the
    hand-written kernel on a CUDA tensor, its plain version on a CPU
    tensor or with ``impl="ref"``.

    Returns (out, (pool_k, pool_v)).
    """
    from repro_torch.kernels.paged_attention import paged_attention
    dt = dtype_of(cfg.compute_dtype)
    q, k, v = _qkv(p, x, cfg)
    cos, sin = rotary_embedding(cache_len[:, None], cfg.head_dim,
                                cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    nb, bs = pool_k.shape[0] - 1, pool_k.shape[1]
    mb = block_tables.shape[1]
    col = (cache_len // bs).clamp(0, mb - 1)
    blk = block_tables.gather(1, col[:, None].long())[:, 0]
    if active is not None:
        blk = torch.where(active, blk, nb)
    flat = _drop_to_sink(blk, nb) * bs + (cache_len % bs).long()
    for pool, new in ((pool_k, k), (pool_v, v)):
        pool.view(-1, *pool.shape[2:]).index_copy_(
            0, flat, new[:, 0].to(pool.dtype))
    out = paged_attention(q[:, 0], pool_k[:nb].to(dt), pool_v[:nb].to(dt),
                          block_tables, cache_len + 1, impl=impl)[:, None]
    return x + _proj_out(out, p["wo"]), (pool_k, pool_v)


def paged_chunk_attention(p, x, cfg, *, pool_k, pool_v, bt_row, off: int,
                          history=True):
    """Chunk prefill over one slot's paged KV blocks.

    x: (1, C, d) — C prompt tokens at absolute positions off..off+C-1.
    bt_row: (max_blocks,) the slot's block table; pools carry the sink
    row as in ``paged_decode_attention``.  Gathers the slot's blocks
    (table clamped) into a contiguous (1, S_max, KV, D) view, writes the
    chunk's kv at ``off`` (start clamped so the chunk fits, as
    ``dynamic_update_slice`` does), attends causally at ``q_offset=off``
    over history + chunk, and scatters the rows back through the table
    (sentinel entries into the sink row).

    ``history=False`` is the first-chunk (``off == 0``) specialization:
    causal attention within the chunk plus a scatter of only the chunk's
    own blocks.

    Returns (out, pool_k, pool_v), the pools updated in place.
    """
    dt = dtype_of(cfg.compute_dtype)
    c = x.shape[1]
    q, k, v = _qkv(p, x, cfg)
    positions = off + torch.arange(c, device=x.device)
    cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    nb, bs = pool_k.shape[0] - 1, pool_k.shape[1]
    if not history:
        out = full_attention(q, k.to(dt), v.to(dt), causal=True)
        n_blk = -(-c // bs)
        dest = _drop_to_sink(bt_row[:n_blk], nb)
        for pool, new in ((pool_k, k), (pool_v, v)):
            rows = F.pad(new[0].to(pool.dtype),
                         (0, 0, 0, 0, 0, n_blk * bs - c))
            pool.index_copy_(0, dest, rows.reshape(n_blk, bs,
                                                   *pool.shape[2:]))
        return x + _proj_out(out, p["wo"]), pool_k, pool_v
    mb = bt_row.shape[0]
    src = bt_row.clamp(0, nb - 1).long()
    start = max(0, min(off, mb * bs - c))
    rows = []
    for pool, new in ((pool_k, k), (pool_v, v)):
        r = pool[src].reshape(1, mb * bs, *pool.shape[2:])
        r[:, start:start + c] = new.to(r.dtype)
        rows.append(r)
    out = full_attention(q, rows[0].to(dt), rows[1].to(dt), causal=True,
                         q_offset=off)
    dest = _drop_to_sink(bt_row, nb)
    for pool, r in zip((pool_k, pool_v), rows):
        pool.index_copy_(0, dest, r.reshape(mb, bs, *pool.shape[2:]))
    return x + _proj_out(out, p["wo"]), pool_k, pool_v


# ----------------------------------------------------------------------------- MLP
def swiglu_block(p, x, cfg):
    """Pre-norm SwiGLU MLP; tensor parallel over ``ff`` where the active
    rules shard it over a model axis (see the module's docstring)."""
    dt = dtype_of(cfg.compute_dtype)
    h = rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    tp = model_split("ff", cfg.d_ff) > 1
    if tp:
        h = copy_to_model(h)
    g = torch.matmul(h, p["w_gate"])
    u = torch.matmul(h, p["w_up"])
    out = torch.matmul(F.silu(g) * u, p["w_down"])
    return x + (reduce_from_model(out) if tp else out)
