"""GShard/Switch-style top-k MoE with capacity-bounded dispatch.

Port of ``repro.models.moe``.  ``moe_block`` takes the reference's
paths:

* ``moe_impl="onehot"``: the one-hot formulation, ``moe_block_onehot``;
* ``_moe_explicit_ep`` under sharding rules with a model axis ``m``
  above 1 that divides the experts (``moe_impl`` "auto"): each rank
  holds experts ``[r E/m, (r+1) E/m)``, routes its local tokens as one
  group, gathers its own experts' slots locally, and the routed output
  is one float32 all-reduce over the model group; where a micro-batch's
  rows do not divide over the batch ranks (pod x data) it falls back to
  ``_moe_grouped``, as the reference does;
* ``_moe_grouped`` otherwise ("grouped", and "auto" without such an
  axis).

Over batch ranks (the pod x data ranks, ``launch.sharding.
batch_group``) the grouped and one-hot dispatches compute the single
device's function of the whole micro-batch.  The rank's rows are a
contiguous block of the micro-batch (its routing pool,
``launch.sharding.routing_pool``: the batch ranks that hold the
micro-batch, in batch-rank order, pods included), and its routing
groups are the reference's consecutive blocks of the pool's tokens,
which may span ranks, pods too, or cut a rank's rows.  Each rank counts
its entries by (group, choice, expert); where a group spans ranks the
ranks all-gather these integer tables over the batch group, and each
entry's position in its expert is that
of the reference's choice-major cumulative sum over the whole group
(``capacity_positions``).  The router statistics of the aux loss are
summed over the pool (``route``).  Counts move, activations do not: a
token's expert output depends on its own row and on whether it was
kept, so each rank runs its own kept entries in an ``(E, C, d)``
buffer per group it touches and combines its own tokens.

Over a model axis the grouped and one-hot paths compute the single
device's function, with the expert weights laid out as the rules lay
them out (``launch.sharding.model_split_dim``): split by experts where
the axis divides them (each rank runs its experts' slots), else by each
expert's ``d_ff`` where the axis divides that (each rank runs every
expert on its block of ``d_ff``), else replicated (each rank runs every
expert whole).

Routing is float32, from a float32 router, whatever the compute dtype;
the expert weights are stored in compute dtype by ``convert``.  Every
expert multiplies its whole capacity buffer, empty slots included, as
the reference does.

What JAX leaves implicit is explicit here:

* ``lax.top_k`` puts the lower index first among equal values: the top
  k is taken from a stable descending ``torch.sort``;
* out-of-range ``.at[].set(mode="drop")`` writes land in a pad slot
  that is sliced off;
* no ``bincount``, ``nonzero``, ``.item()`` or boolean-mask indexing:
  each would wait for the device;
* the combine adds each token's kept contributions in float32 in
  ascending slot (expert) order from 0.0, through an inverse map
  (token, choice) -> slot and a gather, never with float atomics: the
  order of the reference's sequential scatter-add on the CPU, and the
  same bits from run to run on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.launch import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models.schema import Spec


def moe_schema(cfg: ModelConfig, stacked=None, prefix="layers"):
    """The reference's tree; ``router`` is drawn and kept in float32
    (the reference casts it to float32 at every use)."""
    st = (stacked,) if stacked is not None else ()
    sa = (prefix,) if stacked is not None else ()
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    sch = {
        "norm": Spec(st + (d,), sa + (None,), "ones"),
        "router": Spec(st + (d, E), sa + ("embed", None), "normal",
                       "float32"),
        "we_gate": Spec(st + (E, d, f), sa + ("experts", "embed", "expert_ff")),
        "we_up": Spec(st + (E, d, f), sa + ("experts", "embed", "expert_ff")),
        "we_down": Spec(st + (E, f, d), sa + ("experts", "expert_ff", "embed")),
    }
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * f
        sch.update({
            "ws_gate": Spec(st + (d, fs), sa + ("embed", "ff")),
            "ws_up": Spec(st + (d, fs), sa + ("embed", "ff")),
            "ws_down": Spec(st + (fs, d), sa + ("ff", "embed")),
        })
    return sch


def expert_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    cap = int(cfg.capacity_factor * num_tokens * cfg.top_k / cfg.num_experts)
    return max(8, min(cap, num_tokens))


def route(router_logits, cfg: ModelConfig, pool=None):
    """top-k routing. router_logits: (T, E) float32.

    Returns (expert_idx (T, k) int64, weights (T, k), aux_loss scalar).
    ``pool`` (``launch.sharding.routing_pool``, more than one rank): the
    tokens are this rank's block of a micro-batch whose rows the pool's
    batch ranks hold, and the aux loss is the whole micro-batch's: the
    first-choice counts and the sums of the probabilities are summed
    over the pool (one all-reduce, with the adjoint gradient) and
    divided by the tokens they count."""
    # jax.nn.softmax's own formula: exp(x - max) / sum
    e = torch.exp(router_logits - router_logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    weights, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    weights, expert_idx = weights[:, :cfg.top_k], expert_idx[:, :cfg.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balancing auxiliary loss
    E = cfg.num_experts
    experts = torch.arange(E, device=probs.device)
    first = (expert_idx[:, :1] == experts).float()
    if pool is not None and pool.size > 1:
        first_sum, probs_sum = shd.sum_over_pool(
            torch.stack([first.sum(0), probs.sum(0)]), pool).unbind(0)
        n = first_sum.sum()                  # the pool's tokens, counted
        density, density_proxy = first_sum / n, probs_sum / n
    else:
        density = first.mean(0)
        density_proxy = probs.mean(0)
    aux = torch.sum(density * density_proxy) * (E ** 2) / E
    return expert_idx, weights, aux * cfg.router_aux_weight


# ------------------------------------------------------ capacity positions
def _own_positions(key, n_keys: int, onehot: bool):
    """Each entry's position among the entries before it with the same
    ``key`` (entries in order): a cumulative sum of the one-hot keys
    (``onehot``, the GShard formulation) or the rank in a stable sort."""
    if onehot:
        hot = (key[:, None] == torch.arange(n_keys, device=key.device)).to(
            torch.int32)
        return (torch.cumsum(hot, dim=0) - 1).gather(1, key[:, None])[:, 0] \
            .long()
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(n_keys, dtype=torch.int64,
                         device=key.device).scatter_add_(
        0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, dim=0) - counts
    ranks = torch.arange(key.numel(), device=key.device) - starts[key[order]]
    return torch.empty_like(ranks).scatter_(0, order, ranks)


def pool_offsets(tables, q: int):
    """``tables`` (ranks, G, k, E): every rank's entries of a routing pool
    counted by (group, choice, expert), in rank order; ``q``: this
    rank's index.  What to add to the position of one of its entries
    among its own entries of the same (group, expert), counted in
    choice-major order, to give its position in the pool's choice-major
    order: the other ranks' entries of earlier choices, and the earlier
    ranks' entries of the same choice.  (G, k, E)."""
    others = tables.sum(0) - tables[q]
    return (torch.cumsum(others, dim=1) - others) + tables[:q].sum(0)


def capacity_positions(expert_idx, off: int, q: int, Tg: int, G: int,
                       num_experts: int, gather=None, onehot=False):
    """The capacity positions of a rank's block of a routing pool.

    ``expert_idx`` (T, k): the expert choices of the block's tokens,
    tokens ``[off, off + T)`` of the pool, which route in ``G`` groups of
    ``Tg`` consecutive tokens; ``q``: the block's index in the pool.  An
    entry (token, choice ``j``) sits at its position in its expert within
    its group in the reference's choice-major order: every entry of
    choice 0 of the group, then of choice 1, ...  ``gather``: ``None``
    where the block's groups are whole (no other block holds their
    tokens), else a function from this block's table of counts (G, k, E)
    to every block's, (blocks, G, k, E) in block order (an all-gather
    over the batch ranks).

    Returns ``(pos, key, Gt)`` over the block's entries in choice-major
    order: the position, the entry's (group - first group of the block)
    * E + expert, and the number of groups the block touches."""
    T, k = expert_idx.shape
    E = num_experts
    dev = expert_idx.device
    g0 = off // Tg
    Gt = (off + T - 1) // Tg - g0 + 1
    lg = (off + torch.arange(T, device=dev)) // Tg - g0
    flat_e = expert_idx.t().reshape(-1)                        # (k*T,)
    flat_g = lg.repeat(k)
    key = flat_g * E + flat_e
    pos = _own_positions(key, Gt * E, onehot)
    if gather is not None:
        choice = torch.arange(k, device=dev).repeat_interleave(T)
        cell = ((g0 + flat_g) * k + choice) * E + flat_e
        table = torch.zeros(G * k * E, dtype=torch.int64,
                            device=dev).scatter_add_(
            0, cell, torch.ones_like(cell)).view(G, k, E)
        pos = pos + pool_offsets(gather(table), q).reshape(-1)[cell]
    return pos, key, Gt


def _positions(expert_idx, pool, Tg: int, G: int, num_experts: int,
               onehot=False):
    """``capacity_positions`` of this rank's tokens in its routing
    ``pool`` (every rank of it holds as many): the count tables are
    all-gathered over the batch group where a group spans ranks or cuts a
    rank's rows; every rank of the batch group takes the same branch."""
    T = expert_idx.shape[0]
    q = 0 if pool is None else pool.index
    gather = None
    if pool is not None and pool.size > 1 and T % Tg:
        def gather(table):
            return shd.gather_over_batch(table)[pool.lo:pool.lo + pool.size]
    return capacity_positions(expert_idx, q * T, q, Tg, G, num_experts,
                              gather, onehot)


# ------------------------------------------------------------- the blocks
def _shared_experts(p, h, out, cfg: ModelConfig):
    """``out`` plus the shared experts' SwiGLU of ``h``; tensor parallel
    over ``ff`` (f before, g after) where the rules shard it over a model
    axis, whole otherwise."""
    if "ws_gate" not in p:
        return out
    tp = shd.model_split("ff", cfg.num_shared_experts * cfg.d_ff) > 1
    if tp:
        h = shd.copy_to_model(h)
    gs = torch.matmul(h, p["ws_gate"])
    us = torch.matmul(h, p["ws_up"])
    sh = torch.matmul(F.silu(gs) * us, p["ws_down"])
    return out + (shd.reduce_from_model(sh) if tp else sh)


def _expert_split(cfg: ModelConfig):
    """Which dimension of an expert weight ``(E, d, d_ff)`` the active
    rules split over a model axis above 1: 0 (the experts), 2 (each
    expert's ``d_ff``) or ``None`` (replicated, or no model axis)."""
    return shd.model_split_dim(("experts", "embed", "expert_ff"),
                               (cfg.num_experts, cfg.d_model, cfg.d_ff))


def _rank_experts(cfg: ModelConfig, split):
    """The experts this rank runs, ``(e0, n)`` for ``[e0, e0 + n)``: its
    block where the rules split the experts over the model axis
    (``split == 0``), else all of them."""
    if split != 0:
        return 0, cfg.num_experts
    tp = shd.model_axis()
    n = cfg.num_experts // tp.size
    return tp.rank * n, n


def _pool_tokens(T: int, pool) -> int:
    """The tokens of the micro-batch this rank's ``T`` are a block of."""
    return T * (1 if pool is None else pool.size)


def moe_block(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d), aux_loss.  ``moe_impl="onehot"`` runs
    ``moe_block_onehot``; "auto" under rules whose model axis above 1
    takes the experts runs ``_moe_explicit_ep``; else ``_moe_grouped``.
    Over batch ranks each routes this rank's block of the micro-batch as
    the reference routes the whole one (``routing_pool``)."""
    if cfg.moe_impl == "onehot":
        return moe_block_onehot(p, x, cfg)
    if cfg.moe_impl != "grouped" and _expert_split(cfg) == 0:
        return _moe_explicit_ep(p, x, cfg)
    return _moe_grouped(p, x, cfg)


def _dispatch(router, ht, cfg: ModelConfig, G: int, Tg: int, pool):
    """The routing of this rank's tokens ``ht`` (T, d), a block of its
    routing ``pool``'s tokens (``None``: all of them), which route in
    ``G`` groups of ``Tg``.  Returns ``(slot, tok_of_slot, w_of_slot,
    aux, C, Gt)``: each entry's slot (choice-major entries; slots are
    (group touched, expert, position), ``Gt * E * C`` where the entry is
    dropped), slot -> token (``T`` where empty) and slot -> weight over
    the ``Gt * E * C`` slots of the ``Gt`` groups the block touches."""
    E, k = cfg.num_experts, cfg.top_k
    T = ht.shape[0]
    C = expert_capacity(cfg, Tg)
    dev = ht.device
    router_logits = torch.matmul(ht.float(), router.float())
    expert_idx, weights, aux = route(router_logits, cfg, pool)
    pos, key, Gt = _positions(expert_idx, pool, Tg, G, E)
    n_slots = Gt * E * C
    slot = torch.where(pos < C, key * C + pos.clamp(max=C - 1), n_slots)
    tok_of_slot = torch.full((n_slots + 1,), T, dtype=torch.int64,
                             device=dev).scatter_(
        0, slot, torch.arange(T, device=dev).repeat(k))[:n_slots]
    w_of_slot = torch.zeros(n_slots + 1, device=dev).scatter_(
        0, slot, weights.t().reshape(-1))[:n_slots]
    return slot, tok_of_slot, w_of_slot, aux, C, Gt


def _routing_tables(p, ht, cfg: ModelConfig, G: int, Tg: int):
    """The reference's routing tables of ``ht`` (G, Tg, d) on one
    device: slot -> token within the group (``Tg`` where empty) and slot
    -> weight, (G, E*C) each, plus (aux, C)."""
    _, tok, w, aux, C, _ = _dispatch(p["router"], ht.reshape(G * Tg, -1),
                                     cfg, G, Tg, None)
    tok = tok.view(G, -1)
    first = torch.arange(G, device=tok.device)[:, None] * Tg
    tok = torch.where(tok == G * Tg, Tg, tok - first)
    return tok, w.view(G, -1), aux, C


def _experts(buf, p):
    """buf (E, M, d) -> (E, M, d): every expert's SwiGLU FFN as batched
    matmuls over its own rows."""
    g = torch.bmm(buf, p["we_gate"])
    u = torch.bmm(buf, p["we_up"])
    return torch.bmm(F.silu(g) * u, p["we_down"])


def _combine(out_flat, slot, k: int, T: int):
    """Each token's kept contributions ``out_flat`` (slots + 1, d)
    float32, the last row zero, summed in ascending slot order from 0.0,
    one choice at a time: (T, d).  ``slot`` (k*T,) holds each
    choice-major entry's row of ``out_flat``."""
    slot_of = slot.view(k, T).t().sort(dim=-1).values          # (T, k)
    terms = out_flat[slot_of]                                  # (T, k, d)
    combined = torch.zeros(T, out_flat.shape[-1], device=out_flat.device)
    for j in range(k):
        combined = combined + terms[:, j]
    return combined


def _routed(p, h, cfg: ModelConfig, G: int, Tg: int, pool):
    """The routed experts' output for this rank's normed tokens ``h``
    (any leading shape, ``T`` tokens), a block of its routing ``pool``'s
    tokens (``None``: all of them) routed in ``G`` groups of ``Tg``:
    ((T, d) float32, aux loss).  The rank runs the slots of the groups
    its tokens touch (``_dispatch``), and each token's kept slots are
    combined in float32 in ascending slot order.

    Over a model axis ``m`` the expert weights ``p["we_*"]`` are this
    rank's as the rules lay them out (``_expert_split``):

    * the experts split: the rank gathers and runs the slots of its
      experts ``[r E/m, (r+1) E/m)`` in every group; the other ranks'
      slots (and dropped choices) read a zero row in the combine;
    * ``d_ff`` split: the rank runs every expert on its ``d_ff / m``
      columns of ``we_gate`` / ``we_up`` and rows of ``we_down``;
    * replicated: every rank runs every expert whole, with no collective.

    Split either way, the rank's float32 combine is a partial sum of the
    whole one, and one all-reduce over the model group (g) gives it.
    The input and the router enter through f, so the ranks' partial
    gradients sum; the aux loss, the same on every model rank, has its
    gradient divided by ``m`` so that the sum counts it once."""
    E, k = cfg.num_experts, cfg.top_k
    d = h.shape[-1]
    split = _expert_split(cfg)
    router = p["router"]
    if split is not None:
        h, router = shd.copy_to_model(h), shd.copy_to_model(router)
    ht = h.reshape(-1, d)
    T = ht.shape[0]
    slot, tok_of_slot, w_of_slot, aux, C, Gt = _dispatch(
        router, ht, cfg, G, Tg, pool)
    # the experts this rank runs and their slots in each group
    e0, n_e = _rank_experts(cfg, split)
    lo, n = e0 * C, n_e * C

    # dispatch: a gather; empty slots read a zero pad row
    ht_pad = torch.cat([ht, ht.new_zeros(1, d)], dim=0)
    buf = ht_pad[tok_of_slot.view(Gt, E * C)[:, lo:lo + n]]
    buf = buf.reshape(Gt, n_e, C, d).transpose(0, 1).reshape(n_e, Gt * C, d)
    out_buf = _experts(buf, p).reshape(n_e, Gt, C, d).transpose(0, 1)

    # combine in float32: each token's kept slots (the inverse map) in
    # ascending slot order, dropped choices on a zero pad row, summed
    # from 0.0 one choice at a time
    w = w_of_slot.view(Gt, E * C)[:, lo:lo + n].reshape(Gt * n, 1)
    out_flat = torch.cat([out_buf.reshape(Gt * n, d).float() * w,
                          out_buf.new_zeros(1, d, dtype=torch.float32)])
    if split == 0:
        g, s = slot // (E * C), slot % (E * C) - lo
        slot = torch.where((g < Gt) & (s >= 0) & (s < n), g * n + s, Gt * n)
    combined = _combine(out_flat, slot, k, T)
    if split is not None:
        combined = shd.reduce_from_model(combined)
        aux = shd.scale_grad(aux, 1.0 / shd.model_axis().size)
    return combined, aux


def _moe_explicit_ep(p, x, cfg: ModelConfig):
    """Explicit expert parallelism (``repro/models/moe.py:138-216``): the
    batch is split over the batch ranks (pod x data) and replicated over
    the model ranks, and model rank ``r`` holds experts ``[r E_loc, (r+1)
    E_loc)``
    (``p["we_*"]`` are those).  Each rank routes its local tokens as one
    group (capacity from ``T_loc``) and runs its own experts' slots
    (``_routed``); one float32 all-reduce over the model group gives the
    routed output, cast to the compute dtype.  The aux loss is the mean
    over the batch ranks of each rank's (with the gradient of a mean).
    Where the micro-batch's rows do not divide over the batch ranks (its
    routing pool is not the whole batch group) it is ``_moe_grouped``, as
    in the reference (``repro/models/moe.py:159-160``)."""
    pool = shd.routing_pool()
    if pool is not None and pool.size < pool.axis.size:
        return _moe_grouped(p, x, cfg)
    dt = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    combined, aux = _routed(p, h, cfg, 1, b * s, None)
    out = combined.to(dt).reshape(b, s, d)
    if pool is not None:
        aux = shd.sum_over_batch(aux) / pool.size
    return x + _shared_experts(p, h, out, cfg), aux


def _moe_grouped(p, x, cfg: ModelConfig):
    """Sort-based grouped dispatch (GShard capacity per group), the
    single device's function at any mesh.

    The groups are the reference's: ``moe_groups`` consecutive blocks of
    the micro-batch's tokens where they divide them, else one.  Over
    batch ranks this rank's rows ``x`` are a block of the micro-batch
    (``routing_pool``): a group whole on the rank routes locally, and
    the positions in a group that spans ranks or cuts the rank's rows
    come from the pool's count tables (``capacity_positions``); the
    router statistics are summed over the pool (``route``).  Over a
    model axis the experts run as ``_routed`` lays them out."""
    dt = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    pool = shd.routing_pool()
    Tp = _pool_tokens(b * s, pool)
    G = cfg.moe_groups if Tp % max(cfg.moe_groups, 1) == 0 else 1
    h = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    combined, aux = _routed(p, h, cfg, G, Tp // G, pool)
    out = combined.to(dt).reshape(b, s, d)
    return x + _shared_experts(p, h, out, cfg), aux


def moe_block_onehot(p, x, cfg: ModelConfig):
    """One-hot/cumsum dispatch (GShard formulation) over all T tokens of
    the micro-batch: the reference's second oracle for the sort-based
    path.

    Over batch ranks this rank's rows are a block of the micro-batch
    (``routing_pool``): capacity is the micro-batch's, each entry's
    position the whole micro-batch's cumulative sum (this rank's one-hot
    cumulative sum plus the pool's count tables, ``capacity_positions``),
    and the rank fills its own kept entries into an ``(E, C, d)`` buffer,
    runs it and combines its own tokens; the router statistics are
    summed over the pool (``route``).

    Over a model axis the expert weights are the rank's as in
    ``_routed``: the rank runs its experts' capacity buffers, or every
    expert on its ``d_ff`` block, or every expert whole (replicated: the
    single device's code, no collective).  Split either way, the rank's
    weighted contributions (each in the compute dtype, as the
    reference's) are summed in float32, all-reduced over the model group
    and cast: in float32 the reference's sum in another order, in bf16
    one rounding at the end where the reference rounds after every
    choice (within the bf16 tolerance)."""
    dt = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    T = b * s
    E, k = cfg.num_experts, cfg.top_k
    pool = shd.routing_pool()
    Tp = _pool_tokens(T, pool)
    C = expert_capacity(cfg, Tp)
    dev = x.device

    h = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    split = _expert_split(cfg)
    hr, router = h, p["router"]
    if split is not None:
        hr, router = shd.copy_to_model(h), shd.copy_to_model(router)
    ht = hr.reshape(T, d)
    router_logits = torch.matmul(ht.float(), router.float())
    expert_idx, weights, aux = route(router_logits, cfg, pool)

    flat_e = expert_idx.t().reshape(-1)                        # (k*T,)
    pos_in_e = _positions(expert_idx, pool, Tp, 1, E, onehot=True)[0]
    keep = pos_in_e < C
    pos_c = pos_in_e.clamp(0, C - 1)

    tok_idx = torch.arange(T, device=dev).repeat(k)
    # a dropped entry adds zero to a kept one's slot: exact in any order
    src = ht[tok_idx] * keep[:, None].to(dt)
    buf = torch.zeros(E, C, d, dtype=dt, device=dev).index_put_(
        (flat_e, pos_c), src, accumulate=True)
    flat_w = weights.t().reshape(-1).to(dt) * keep.to(dt)
    if split is None:
        out_buf = _experts(buf, p)
        contrib = (out_buf[flat_e, pos_c] * flat_w[:, None]).reshape(k, T, d)
        # the reference's scatter-add in update order: choice 0 first
        combined = torch.zeros(T, d, dtype=dt, device=dev)
        for j in range(k):
            combined = combined + contrib[j]
        return x + _shared_experts(p, h, combined.reshape(b, s, d), cfg), aux

    e0, n_e = _rank_experts(cfg, split)
    out_buf = _experts(buf[e0:e0 + n_e], p)
    mine = ((flat_e >= e0) & (flat_e < e0 + n_e)).to(dt)
    rows = out_buf[(flat_e - e0).clamp(0, n_e - 1), pos_c]
    contrib = (rows * (flat_w * mine)[:, None]).float().reshape(k, T, d)
    combined = torch.zeros(T, d, device=dev)
    for j in range(k):
        combined = combined + contrib[j]
    out = shd.reduce_from_model(combined).to(dt).reshape(b, s, d)
    aux = shd.scale_grad(aux, 1.0 / shd.model_axis().size)
    return x + _shared_experts(p, h, out, cfg), aux
