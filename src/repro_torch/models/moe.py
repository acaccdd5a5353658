"""GShard/Switch-style top-k MoE with capacity-bounded dispatch.

Port of ``repro.models.moe``.  ``moe_block`` takes the reference's
paths:

* ``moe_impl="onehot"``: the one-hot formulation, ``moe_block_onehot``;
* ``_moe_explicit_ep`` under sharding rules with a model axis ``m``
  above 1 that divides the experts (``moe_impl`` "auto"): each rank
  holds experts ``[r E/m, (r+1) E/m)``, routes its local tokens as one
  group, gathers its own experts' slots locally, and the routed output
  is one float32 all-reduce over the model group;
* ``_moe_grouped`` otherwise ("grouped", and "auto" without such an
  axis): over data ranks (rules with a data axis above 1) each rank
  routes its rows' groups and the router statistics are summed over
  the data group, so the loss is the single device's.

Over a model axis the grouped and one-hot paths compute the single
device's function, with the expert weights laid out as the rules lay
them out (``launch.sharding.model_split_dim``): split by experts where
the axis divides them (each rank runs its experts' slots), else by each
expert's ``d_ff`` where the axis divides that (each rank runs every
expert on its block of ``d_ff``), else replicated (each rank runs every
expert whole).  The one-hot dispatch over data ranks, routing groups
that do not split over the data ranks and micro-batches that do not
split over them raise: ROADMAP item 13c's fourth step.

Routing is float32, from a float32 router, whatever the compute dtype;
the expert weights are stored in compute dtype by ``convert``.  Every
expert multiplies its whole capacity buffer, empty slots included, as
the reference does.

What JAX leaves implicit is explicit here:

* ``lax.top_k`` puts the lower index first among equal values: the top
  k is taken from a stable descending ``torch.sort``;
* out-of-range ``.at[].set(mode="drop")`` writes land in a pad column
  (``E * C``) that is sliced off;
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


def route(router_logits, cfg: ModelConfig, over_data: bool = False):
    """top-k routing. router_logits: (T, E) float32.

    Returns (expert_idx (T, k) int64, weights (T, k), aux_loss scalar).
    ``over_data``: the tokens are this rank's share of a batch split
    over the active rules' data axis, and the aux loss is the whole
    batch's: the first-choice counts and the sums of the probabilities
    are summed over the data group (with the adjoint gradient) before
    their product."""
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
    if over_data:
        n = probs.shape[0] * shd.data_axis().size
        density = shd.sum_over_data(first.sum(0)) / n
        density_proxy = shd.sum_over_data(probs.sum(0)) / n
    else:
        density = first.mean(0)
        density_proxy = probs.mean(0)
    aux = torch.sum(density * density_proxy) * (E ** 2) / E
    return expert_idx, weights, aux * cfg.router_aux_weight


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


def _not_ported(cfg: ModelConfig, why: str):
    raise NotImplementedError(
        f"{cfg.name} (moe_impl {cfg.moe_impl!r}, {cfg.num_experts} "
        f"experts): {why} is not ported: ROADMAP item 13c's fourth step")


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


def moe_block(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d), aux_loss.  ``moe_impl="onehot"`` runs
    ``moe_block_onehot``; "auto" under rules whose model axis above 1
    takes the experts runs ``_moe_explicit_ep``; else ``_moe_grouped``
    (over the data ranks where the rules have a data axis above 1)."""
    if cfg.moe_impl == "onehot":
        if shd.data_axis() is not None:
            _not_ported(cfg, "the one-hot dispatch over data ranks")
        return moe_block_onehot(p, x, cfg)
    if cfg.moe_impl != "grouped" and _expert_split(cfg) == 0:
        return _moe_explicit_ep(p, x, cfg)
    return _moe_grouped(p, x, cfg)


def _dispatch(p, ht, cfg: ModelConfig, G: int, Tg: int,
              over_data: bool = False):
    """The routing of ``ht`` (G, Tg, d): each (group, choice-major
    entry)'s capacity slot, ``E * C`` where it is dropped, in the stable
    sort's order, with that order, the entries' tokens and weights, the
    aux loss and C (``over_data``: see ``route``)."""
    E, k = cfg.num_experts, cfg.top_k
    C = expert_capacity(cfg, Tg)
    kTg = k * Tg
    dev = ht.device
    router_logits = torch.matmul(ht.float(), p["router"].float())
    expert_idx, weights, aux = route(router_logits.reshape(G * Tg, E), cfg,
                                     over_data)
    expert_idx = expert_idx.reshape(G, Tg, k)
    weights = weights.reshape(G, Tg, k)

    # choice-major flattening per group: first choices precede second
    # choices, so the stable sort preserves Switch-style drop priority.
    flat_e = expert_idx.transpose(1, 2).reshape(G, kTg)
    flat_tok = torch.arange(Tg, device=dev).repeat(G, k)
    flat_w = weights.transpose(1, 2).reshape(G, kTg)

    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order)
    counts = torch.zeros(G, E, dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = (torch.arange(kTg, device=dev)[None]
            - starts.gather(1, sorted_e))
    slot = sorted_e * C + rank.clamp(0, C - 1)
    slot_or_oob = torch.where(rank < C, slot, E * C)          # capacity drop
    return slot_or_oob, order, flat_tok, flat_w, aux, C


def _slot_tables(slot_or_oob, order, flat_tok, flat_w, E: int, C: int,
                 Tg: int):
    """slot -> token (``Tg`` where empty) and slot -> weight, (G, E*C)."""
    G = slot_or_oob.shape[0]
    dev = slot_or_oob.device
    tok_of_slot = torch.full((G, E * C + 1), Tg, dtype=torch.int64,
                             device=dev).scatter_(
        1, slot_or_oob, flat_tok.gather(1, order))[:, :E * C]
    w_of_slot = torch.zeros(G, E * C + 1, device=dev).scatter_(
        1, slot_or_oob, flat_w.gather(1, order))[:, :E * C]
    return tok_of_slot, w_of_slot


def _routing_tables(p, ht, cfg: ModelConfig, G: int, Tg: int):
    """Shared routing math: slot -> token / slot -> weight tables per
    group.  ht: (G, Tg, d).  Returns (tok_of_slot, w_of_slot) of shape
    (G, E*C) plus (aux, C)."""
    slot_or_oob, order, flat_tok, flat_w, aux, C = _dispatch(
        p, ht, cfg, G, Tg)
    tok_of_slot, w_of_slot = _slot_tables(
        slot_or_oob, order, flat_tok, flat_w, cfg.num_experts, C, Tg)
    return tok_of_slot, w_of_slot, aux, C


def _experts(buf, p):
    """buf (E, M, d) -> (E, M, d): every expert's SwiGLU FFN as batched
    matmuls over its own rows."""
    g = torch.bmm(buf, p["we_gate"])
    u = torch.bmm(buf, p["we_up"])
    return torch.bmm(F.silu(g) * u, p["we_down"])


def _combine(out_flat, slot_or_oob, order, k: int, Tg: int):
    """Each token's kept contributions ``out_flat`` (G, slots + 1, d)
    float32, the last row zero, summed in ascending slot order from 0.0,
    one choice at a time: (G, Tg, d).  ``slot_or_oob`` (G, kTg) holds
    each entry's row of ``out_flat`` in the stable sort's ``order``."""
    G = slot_or_oob.shape[0]
    gidx = torch.arange(G, device=out_flat.device)[:, None, None]
    slot_of = torch.empty_like(slot_or_oob).scatter_(1, order, slot_or_oob)
    slot_of = slot_of.reshape(G, k, Tg).transpose(1, 2).sort(dim=-1).values
    terms = out_flat[gidx, slot_of]                           # (G, Tg, k, d)
    combined = torch.zeros(G, Tg, out_flat.shape[-1], device=out_flat.device)
    for j in range(k):
        combined = combined + terms[:, :, j]
    return combined


def _routed(p, h, cfg: ModelConfig, G: int, Tg: int,
            over_data: bool = False):
    """The routed experts' output for the normed input ``h`` (``G * Tg``
    tokens) routed in ``G`` groups of ``Tg``: ((G, Tg, d) float32, aux
    loss) (``over_data``: see ``route``).  Each token's kept slots are
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
    ht = h.reshape(G, Tg, d)
    slot_or_oob, order, flat_tok, flat_w, aux, C = _dispatch(
        {"router": router}, ht, cfg, G, Tg, over_data)
    tok_of_slot, w_of_slot = _slot_tables(
        slot_or_oob, order, flat_tok, flat_w, E, C, Tg)
    # the experts this rank runs and their slots
    e0, n_e = _rank_experts(cfg, split)
    lo, n = e0 * C, n_e * C

    # dispatch: a group-local gather; empty slots read a zero pad row
    gidx = torch.arange(G, device=h.device)[:, None]
    ht_pad = torch.cat([ht, ht.new_zeros(G, 1, d)], dim=1)
    buf = ht_pad[gidx, tok_of_slot[:, lo:lo + n]].reshape(G, n_e, C, d)
    buf = buf.transpose(0, 1).reshape(n_e, G * C, d)
    out_buf = _experts(buf, p).reshape(n_e, G, C, d).transpose(0, 1)

    # combine in float32: each token's kept slots (the inverse map) in
    # ascending slot order, dropped choices on a zero pad row, summed
    # from 0.0 one choice at a time
    out_flat = torch.cat([
        out_buf.reshape(G, n, d).float() * w_of_slot[:, lo:lo + n, None],
        out_buf.new_zeros(G, 1, d, dtype=torch.float32)], dim=1)
    if split == 0:
        local = slot_or_oob - lo
        slot_or_oob = torch.where((local >= 0) & (local < n), local, n)
    combined = _combine(out_flat, slot_or_oob, order, k, Tg)
    if split is not None:
        combined = shd.reduce_from_model(combined)
        aux = shd.scale_grad(aux, 1.0 / shd.model_axis().size)
    return combined, aux


def _moe_explicit_ep(p, x, cfg: ModelConfig):
    """Explicit expert parallelism (``repro/models/moe.py:138-216``): the
    batch is split over the data ranks and replicated over the model
    ranks, and model rank ``r`` holds experts ``[r E_loc, (r+1) E_loc)``
    (``p["we_*"]`` are those).  Each rank routes its local tokens as one
    group (capacity from ``T_loc``) and runs its own experts' slots
    (``_routed``); one float32 all-reduce over the model group gives the
    routed output, cast to the compute dtype.  The aux loss is the mean
    over the data ranks of each rank's (with the gradient of a mean)."""
    dt = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    combined, aux = _routed(p, h, cfg, 1, b * s)
    out = combined.to(dt).reshape(b, s, d)
    dp = shd.data_axis()
    if dp is not None:
        aux = shd.sum_over_data(aux) / dp.size
    return x + _shared_experts(p, h, out, cfg), aux


def _moe_grouped(p, x, cfg: ModelConfig):
    """Sort-based grouped dispatch (GShard capacity per group), the
    single device's function at any mesh.

    Over data ranks (the active rules' data axis above 1, this rank's
    rows ``x`` of a batch split evenly over them) the groups are the
    whole batch's ``moe_groups``: each rank routes its rows' groups,
    which must be whole (the groups divide over the ranks), and the
    router statistics are summed over the data group (``route``), so
    that the loss is the single device's.  Over a model axis the experts
    run as ``_routed`` lays them out."""
    dt = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    T = b * s
    dp = shd.data_axis()
    n = 1 if dp is None else dp.size
    G = cfg.moe_groups if (T * n) % max(cfg.moe_groups, 1) == 0 else 1
    if G % n:
        raise ValueError(
            f"{cfg.name}: {G} routing group(s) of the batch do not split "
            f"over {n} data ranks, so a rank's rows would not be whole "
            f"groups and its routing would not be the single device's: "
            f"ROADMAP item 13c's fourth step")
    G //= n
    h = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    combined, aux = _routed(p, h, cfg, G, T // G, over_data=dp is not None)
    out = combined.to(dt).reshape(b, s, d)
    return x + _shared_experts(p, h, out, cfg), aux


def moe_block_onehot(p, x, cfg: ModelConfig):
    """One-hot/cumsum dispatch (GShard formulation) over all T tokens:
    the reference's second oracle for the sort-based path.

    Over a model axis (one data rank) the expert weights are the rank's
    as in ``_routed``: the rank runs its experts' capacity buffers, or
    every expert on its ``d_ff`` block, or every expert whole
    (replicated: the single device's code, no collective).  Split either
    way, the rank's weighted contributions (each in the compute dtype,
    as the reference's) are summed in float32, all-reduced over the
    model group and cast: in float32 the reference's sum in another
    order, in bf16 one rounding at the end where the reference rounds
    after every choice (within the bf16 tolerance)."""
    dt = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    T = b * s
    E, k = cfg.num_experts, cfg.top_k
    C = expert_capacity(cfg, T)
    dev = x.device

    h = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    split = _expert_split(cfg)
    hr, router = h, p["router"]
    if split is not None:
        hr, router = shd.copy_to_model(h), shd.copy_to_model(router)
    ht = hr.reshape(T, d)
    router_logits = torch.matmul(ht.float(), router.float())
    expert_idx, weights, aux = route(router_logits, cfg)

    flat_e = expert_idx.t().reshape(-1)                        # (k*T,)
    onehot = (flat_e[:, None] == torch.arange(E, device=dev)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1                      # (kT, E)
    pos_in_e = pos.gather(1, flat_e[:, None])[:, 0]
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
