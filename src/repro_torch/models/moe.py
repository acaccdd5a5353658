"""GShard/Switch-style top-k MoE with capacity-bounded dispatch.

Port of ``repro.models.moe`` without ``_moe_explicit_ep`` (its
``shard_map`` expert parallelism waits for the port's meshes, ROADMAP
item 13): the port has no mesh, so ``moe_block`` takes the reference's
own path without one, ``_moe_grouped`` (``moe_impl`` "auto" or
"grouped"), or the one-hot formulation (``moe_impl="onehot"``).

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


def route(router_logits, cfg: ModelConfig):
    """top-k routing. router_logits: (T, E) float32.

    Returns (expert_idx (T, k) int64, weights (T, k), aux_loss scalar)."""
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
    density = (expert_idx[:, :1] == experts).float().mean(0)
    density_proxy = probs.mean(0)
    aux = torch.sum(density * density_proxy) * (E ** 2) / E
    return expert_idx, weights, aux * cfg.router_aux_weight


def _shared_experts(p, h, out):
    if "ws_gate" not in p:
        return out
    gs = torch.matmul(h, p["ws_gate"])
    us = torch.matmul(h, p["ws_up"])
    return out + torch.matmul(F.silu(gs) * us, p["ws_down"])


def moe_block(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d), aux_loss.  ``moe_impl="onehot"`` runs
    ``moe_block_onehot``; "auto" and "grouped" run ``_moe_grouped``."""
    if cfg.moe_impl == "onehot":
        return moe_block_onehot(p, x, cfg)
    return _moe_grouped(p, x, cfg)


def _dispatch(p, ht, cfg: ModelConfig, G: int, Tg: int):
    """The routing of ``ht`` (G, Tg, d): each (group, choice-major
    entry)'s capacity slot, ``E * C`` where it is dropped, in the stable
    sort's order, with that order, the entries' tokens and weights, the
    aux loss and C."""
    E, k = cfg.num_experts, cfg.top_k
    C = expert_capacity(cfg, Tg)
    kTg = k * Tg
    dev = ht.device
    router_logits = torch.matmul(ht.float(), p["router"].float())
    expert_idx, weights, aux = route(router_logits.reshape(G * Tg, E), cfg)
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


def _moe_grouped(p, x, cfg: ModelConfig):
    """Sort-based grouped dispatch (GShard capacity per group)."""
    dt = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    T = b * s
    E, k = cfg.num_experts, cfg.top_k
    G = cfg.moe_groups if T % max(cfg.moe_groups, 1) == 0 else 1
    Tg = T // G

    h = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    ht = h.reshape(G, Tg, d)
    slot_or_oob, order, flat_tok, flat_w, aux, C = _dispatch(
        p, ht, cfg, G, Tg)
    tok_of_slot, w_of_slot = _slot_tables(
        slot_or_oob, order, flat_tok, flat_w, E, C, Tg)

    # dispatch: a group-local gather; empty slots read a zero pad row
    gidx = torch.arange(G, device=x.device)[:, None]
    ht_pad = torch.cat([ht, ht.new_zeros(G, 1, d)], dim=1)
    buf = ht_pad[gidx, tok_of_slot].reshape(G, E, C, d)
    buf = buf.transpose(0, 1).reshape(E, G * C, d)
    out_buf = _experts(buf, p).reshape(E, G, C, d).transpose(0, 1)

    # combine in float32: each token's kept slots (the inverse map) in
    # ascending slot order, dropped choices on a zero pad row, summed
    # from 0.0 one choice at a time
    out_flat = torch.cat([
        out_buf.reshape(G, E * C, d).float() * w_of_slot[:, :, None],
        out_buf.new_zeros(G, 1, d, dtype=torch.float32)], dim=1)
    slot_of = torch.empty_like(slot_or_oob).scatter_(1, order, slot_or_oob)
    slot_of = slot_of.reshape(G, k, Tg).transpose(1, 2).sort(dim=-1).values
    terms = out_flat[gidx[:, :, None], slot_of]                # (G, Tg, k, d)
    combined = torch.zeros(G, Tg, d, device=x.device)
    for j in range(k):
        combined = combined + terms[:, :, j]
    out = combined.to(dt).reshape(b, s, d)
    return x + _shared_experts(p, h, out), aux


def moe_block_onehot(p, x, cfg: ModelConfig):
    """One-hot/cumsum dispatch (GShard formulation) over all T tokens:
    the reference's second oracle for the sort-based path."""
    dt = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    T = b * s
    E, k = cfg.num_experts, cfg.top_k
    C = expert_capacity(cfg, T)
    dev = x.device

    h = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    ht = h.reshape(T, d)
    router_logits = torch.matmul(ht.float(), p["router"].float())
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
    out_buf = _experts(buf, p)

    flat_w = weights.t().reshape(-1).to(dt) * keep.to(dt)
    contrib = (out_buf[flat_e, pos_c] * flat_w[:, None]).reshape(k, T, d)
    # the reference's scatter-add in update order: choice 0 first
    combined = torch.zeros(T, d, dtype=dt, device=dev)
    for j in range(k):
        combined = combined + contrib[j]
    out = combined.reshape(b, s, d)
    return x + _shared_experts(p, h, out), aux
