"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block.

Port of ``repro.models.mamba2``.  Prefill uses the chunked SSD form:
within a chunk the output is a (masked) quadratic attention-like product;
across chunks a small recurrent state (H heads x P head_dim x N
ssm_state) is passed.  Decode is the O(1) per-token recurrence on that
state.

The intra-chunk half goes through ``kernels.ssd``: the hand-written CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor or with
``impl="ref"``.  The inter-chunk recurrence (``lax.scan`` in the
reference) is a Python loop over chunks.

dtypes follow the reference exactly: ``dt`` and ``A`` are float32, the
SSD core is float32 and its output is cast back to the compute dtype;
``D``, ``conv_w`` and ``conv_b`` are in the compute dtype (``convert``
stores them so), ``A_log`` and ``dt_bias`` stay float32.

Under sharding rules that split ``ssm_heads`` over a model axis above 1
(training or serving over a ``("data", "model")`` mesh) the block is
tensor parallel over its heads, the counterpart of the reference's
constraints at ``mamba2.py:174, 215``: each model rank computes z, x and
dt of its contiguous block of ``nheads / m`` heads, and B and C (one
group, shared by every head) whole; the causal conv runs over its x
channels and the B and C channels, the SSD (the kernel on the card) or
the decode recurrence over its heads, ``ssm_norm`` takes its mean of
squares summed over the model group, and ``out_proj`` is row-parallel
(its ``d_inner`` rows are the heads' channels), its partial sums
all-reduced (g).  The rank's leaves are ``head_leaves``' cut of the
whole ones: in training the block cuts ``in_proj`` and ``conv_w`` read
whole (``models.model_zoo.DataParallel`` gathers them once a step: the
reference's specs cut their packed dimensions in blocks that do not
follow the z / x / B / C / dt parts) and the replicated ``conv_b``,
``A_log``, ``D``, ``dt_bias`` and ``ssm_norm``, whose gradients are then
partial on each rank and summed by ``DataParallel`` over the model
group; in serving ``model_zoo.mesh_blocks`` cuts them once, and the
decode state is the rank's: its heads' SSD state and a conv tail of its
heads' x channels followed by B and C (``head_channels``).  Where the
rules replicate ``ssm_heads`` (a model axis that does not divide them)
every rank runs the whole block.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref  # noqa: F401
from repro_torch.launch.sharding import (copy_to_model, model_axis,
                                         model_split, reduce_from_model,
                                         sum_over_model)
from repro_torch.models import layers as L
from repro_torch.models.schema import Spec


def mamba2_dims(cfg: ModelConfig):
    d_inner = cfg.d_inner
    nheads = cfg.ssm_heads
    conv_dim = d_inner + 2 * cfg.ssm_state  # x + B + C (single group)
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_state + nheads  # z,x,B,C,dt
    return d_inner, nheads, conv_dim, d_in_proj


def mamba2_schema(cfg: ModelConfig, stacked: Optional[tuple] = None,
                  prefix: Tuple[str, ...] = ()):
    """The reference's schema.  ``A_log`` and ``dt_bias`` carry a float32
    dtype: the reference casts them up at use, so drawing (or storing)
    them in a bf16 compute dtype would change ``dt`` and ``A``."""
    st = tuple(stacked) if stacked is not None else ()
    sa = tuple(prefix) if stacked is not None else ()
    d = cfg.d_model
    d_inner, nheads, conv_dim, d_in_proj = mamba2_dims(cfg)
    return {
        "norm": Spec(st + (d,), sa + (None,), "ones"),
        "in_proj": Spec(st + (d, d_in_proj), sa + ("embed", "d_inner")),
        "conv_w": Spec(st + (cfg.conv_width, conv_dim),
                       sa + (None, "conv_dim")),
        "conv_b": Spec(st + (conv_dim,), sa + (None,), "zeros"),
        "A_log": Spec(st + (nheads,), sa + (None,), "ssm_a", "float32"),
        "D": Spec(st + (nheads,), sa + (None,), "ones"),
        "dt_bias": Spec(st + (nheads,), sa + (None,), "ssm_dt", "float32"),
        "ssm_norm": Spec(st + (d_inner,), sa + (None,), "ones"),
        "out_proj": Spec(st + (d_inner, d), sa + ("d_inner", "embed")),
    }


# ----------------------------------------------------------------- SSD core
def ssd_chunked(x, dt, A, B, C, chunk: int, impl: str = "kernel",
                init_state=None):
    """Chunked SSD scan.

    x:  (b, s, h, p)   — per-head inputs
    dt: (b, s, h)      — positive step sizes
    A:  (h,)           — negative decay rates (A = -exp(A_log))
    B:  (b, s, n)      — input projection (single group, shared over heads)
    C:  (b, s, n)      — output projection
    ``init_state`` (b, h, p, n) seeds the inter-chunk recurrence (zeros
    when None): prefilling ``s`` tokens from a carried state is exactly
    equivalent to one longer prefill over history + chunk.
    Returns y: (b, s, h, p) in x's dtype, final_state: (b, h, p, n) f32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    # contiguous float32 copies: x, B and C are column slices of one
    # projection, and the kernel takes dense tensors
    xr = x.reshape(b, nc, chunk, h, p).to(f32).contiguous()
    dtr = dt.reshape(b, nc, chunk, h).to(f32).contiguous()
    Br = B.reshape(b, nc, chunk, n).to(f32).contiguous()
    Cr = C.reshape(b, nc, chunk, n).to(f32).contiguous()
    dA = dtr * A.to(f32)                          # (b,nc,l,h) negative
    dA_cs = torch.cumsum(dA, dim=2)               # within-chunk cumsum

    y_diag, chunk_states = ssd_ops.ssd_intra_chunk(xr, dtr, dA_cs, Br, Cr,
                                                   impl=impl)

    # inter-chunk recurrence on states: (b, nc, h, p, n)
    chunk_decay = torch.exp(dA_cs[:, :, -1])      # (b,nc,h) total chunk decay
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []                                     # state *entering* chunk c
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)        # (b,nc,h,p,n)

    # contribution of the entering state to each position in the chunk
    state_decay = torch.exp(dA_cs)                # (b,nc,l,h)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cr, prev_states) \
        * state_decay[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), state


# ----------------------------------------------------------------- block
def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, written as JAX does."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv1d, width W. xBC: (b, s, c); conv_w: (W, c).

    With ``conv_state`` (b, W-1, c) the window continues from it (the
    streaming decode form, and state-continued prefill); without it the
    window starts from zeros.  Returns (silu(conv + b), the last W-1 rows
    of the window) — the state a following step continues from.  A bf16
    state meets float32 activations upcast, as JAX's concatenate promotes.
    """
    w = conv_w.shape[0]
    if conv_state is not None:
        window = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    else:
        window = F.pad(xBC, (0, 0, w - 1, 0))
    new_state = window[:, -(w - 1):]
    s = xBC.shape[1]
    out = window[:, 0:s] * conv_w[0][None, None]
    for i in range(1, w):
        out = out + window[:, i:i + s] * conv_w[i][None, None]
    return F.silu(out + conv_b[None, None]), new_state


def _step_state(xh, dt, A, B, conv_state, ssm_state, new_conv, active):
    """The single-token recurrence of the heads in ``xh`` (b, 1, h, p):
    the new SSD state (b, h, p, n) float32 and conv tail, lanes whose
    ``active`` is False keeping both of theirs."""
    dA = torch.exp(dt[:, 0] * A[None])                         # (b,h)
    xdt = xh[:, 0].float() * dt[:, 0][..., None]               # (b,h,p)
    upd = xdt[..., None] * B[:, 0].float()[:, None, None, :]
    new_ssm = ssm_state * dA[..., None, None] + upd
    if active is not None:
        new_ssm = torch.where(active[:, None, None, None], new_ssm,
                              ssm_state)
        new_conv = torch.where(active[:, None, None], new_conv,
                               conv_state.to(new_conv.dtype))
    return new_ssm, new_conv


def mamba2_block(p, x, cfg: ModelConfig, *, ssm_state=None, conv_state=None,
                 impl: str = "kernel", active=None, init_ssm=None,
                 init_conv=None):
    """Full Mamba2 block. x: (b, s, d).

    Prefill: ssm_state/conv_state None -> chunked SSD, seeded by
    ``init_ssm`` (b,h,p,n) / ``init_conv`` (b,W-1,conv_dim) for
    state-continued (multi-chunk) prefill.
    Decode: states given (s == 1) -> the recurrent update; lanes whose
    ``active`` is False keep their states.
    Returns (out, (ssm_state, conv_state)): new tensors, the caller's
    states untouched.

    Where the active rules shard ``ssm_heads`` over a model axis above 1
    the block is tensor parallel (``_mamba2_block_tp``), prefill and
    decode; it takes no carried prefill state there (``init_ssm`` /
    ``init_conv``: ``NotImplementedError``).  Where they replicate
    ``ssm_heads`` every rank runs the whole block.
    """
    tp = model_axis()
    if tp is not None and model_split("ssm_heads", cfg.ssm_heads) > 1:
        if init_ssm is not None or init_conv is not None:
            raise NotImplementedError(
                "a tensor-parallel Mamba2 block takes no carried prefill "
                "state")
        return _mamba2_block_tp(p, x, cfg, tp, impl, ssm_state=ssm_state,
                                conv_state=conv_state, active=active)
    dt_c = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    d_inner, nheads, conv_dim, _ = mamba2_dims(cfg)
    n = cfg.ssm_state
    hp = cfg.ssm_head_dim

    h = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt_c)
    proj = torch.matmul(h, p["in_proj"])
    z, xBC, dt_raw = torch.split(proj, [d_inner, conv_dim, nheads], dim=-1)
    dt = softplus(dt_raw.float() + p["dt_bias"].float())       # (b,s,h)

    decoding = ssm_state is not None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                 conv_state if decoding else init_conv)
    xs, B, C = torch.split(xBC, [d_inner, n, n], dim=-1)
    xh = xs.reshape(b, s, nheads, hp)
    A = -torch.exp(p["A_log"].float())                         # (h,)

    if not decoding:
        y, new_ssm = ssd_chunked(xh, dt, A, B, C, min(cfg.ssm_chunk, s),
                                 impl=impl, init_state=init_ssm)
    else:
        # single-token recurrence: state (b,h,p,n)
        new_ssm, new_conv = _step_state(xh, dt, A, B, conv_state, ssm_state,
                                        new_conv, active)
        y = torch.einsum("bhpn,bn->bhp", new_ssm, C[:, 0].float())[:, None]
        y = y.reshape(b, 1, nheads, hp).to(dt_c)

    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(b, s, d_inner)
    y = y * F.silu(z)                                          # gated
    y = L.rms_norm(y, p["ssm_norm"], cfg.norm_eps).to(dt_c)
    out = x + torch.matmul(y, p["out_proj"])
    return out, (new_ssm, new_conv)


def head_block(cfg: ModelConfig, size: int, rank: int) -> Tuple[int, int]:
    """``(first head, heads)`` of model rank ``rank`` of ``size``: a
    contiguous block; ``ValueError`` where ``size`` does not divide the
    heads."""
    nheads = cfg.ssm_heads
    if nheads % size:
        raise ValueError(f"{cfg.name}: {nheads} SSM heads do not split over "
                         f"a model axis of {size}")
    hl = nheads // size
    return rank * hl, hl


def head_channels(t, cfg: ModelConfig, rank: int, size: int):
    """A last axis of ``conv_dim`` channels (x, then B and C) cut to model
    rank ``rank`` of ``size``'s: the x channels of its heads
    (``head_block``) followed by B and C, the order the tensor-parallel
    block's causal conv splits its output in (a new tensor)."""
    d_inner, _, conv_dim, _ = mamba2_dims(cfg)
    h0, hl = head_block(cfg, size, rank)
    hp = cfg.ssm_head_dim
    return torch.cat([t.narrow(-1, h0 * hp, hl * hp),
                      t.narrow(-1, d_inner, conv_dim - d_inner)], dim=-1)


def whole_channels(parts, cfg: ModelConfig):
    """``head_channels``' inverse: the ranks' blocks, in rank order ->
    the whole ``conv_dim`` axis (B and C from the first block; every
    block holds the same)."""
    di = parts[0].shape[-1] - 2 * cfg.ssm_state
    return torch.cat([t.narrow(-1, 0, di) for t in parts]
                     + [parts[0].narrow(-1, di, 2 * cfg.ssm_state)], dim=-1)


# the leaves ``head_leaves`` cuts to a rank's heads
HEAD_LEAVES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
               "ssm_norm")


def head_leaves(p, cfg: ModelConfig, rank: int, size: int):
    """The whole Mamba2 leaves of ``p`` (one layer's, or stacked on
    leading axes) cut to model rank ``rank`` of ``size``'s heads
    (``head_block``), along their last axis: ``in_proj``'s z, x and dt
    columns of those heads with B and C whole, in the order z, x, B, C,
    dt; ``conv_w``'s and ``conv_b``'s ``head_channels``; the heads'
    ``dt_bias``, ``A_log`` and ``D``, and ``ssm_norm`` over their
    channels.  New tensors (``in_proj``, ``conv_w``, ``conv_b``) or
    views; the others in ``p`` (``norm``, ``out_proj``) are not
    returned."""
    d_inner, _, conv_dim, _ = mamba2_dims(cfg)
    h0, hl = head_block(cfg, size, rank)
    c0, di = h0 * cfg.ssm_head_dim, hl * cfg.ssm_head_dim
    w = p["in_proj"]
    return {"in_proj": torch.cat([
                w.narrow(-1, c0, di),
                head_channels(w.narrow(-1, d_inner, conv_dim), cfg, rank,
                              size),
                w.narrow(-1, d_inner + conv_dim + h0, hl)], dim=-1),
            "conv_w": head_channels(p["conv_w"], cfg, rank, size),
            "conv_b": head_channels(p["conv_b"], cfg, rank, size),
            **{k: p[k].narrow(-1, h0, hl) for k in ("A_log", "D", "dt_bias")},
            "ssm_norm": p["ssm_norm"].narrow(-1, c0, di)}


def _mamba2_block_tp(p, x, cfg: ModelConfig, tp, impl: str, *,
                     ssm_state=None, conv_state=None, active=None):
    """``mamba2_block`` over this model rank's heads (see the module's
    docstring), prefill or (states given) decode: the leaves of
    ``HEAD_LEAVES`` whole (training: ``in_proj`` and ``conv_w`` gathered
    by ``DataParallel``; they are cut here by ``head_leaves``) or
    already the rank's (serving: ``model_zoo.serving_params`` cuts them
    once), ``p["out_proj"]`` the rank's rows.  The decode states are the
    rank's: ``ssm_state`` (b, heads, p, n) of its heads and
    ``conv_state`` (b, W-1, channels) its heads' x channels, then B and
    C.  Returns the block's output (the same on every rank) and the
    rank's new states."""
    dt_c = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    d_inner, nheads, conv_dim, d_in_proj = mamba2_dims(cfg)
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    h0, hl = head_block(cfg, tp.size, tp.rank)
    di = hl * hp
    if p["in_proj"].shape[-1] == d_in_proj:
        p = dict(p, **head_leaves(p, cfg, tp.rank, tp.size))
    elif p["in_proj"].shape[-1] != 2 * di + 2 * n + hl:
        raise ValueError(
            f"a tensor-parallel Mamba2 block reads in_proj whole "
            f"({d_in_proj} columns) or its heads' ({2 * di + 2 * n + hl}), "
            f"got {p['in_proj'].shape[-1]}")
    h = copy_to_model(L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt_c))
    z, xBC, dt_raw = torch.split(torch.matmul(h, p["in_proj"]),
                                 [di, di + 2 * n, hl], dim=-1)
    dt = softplus(dt_raw.float() + p["dt_bias"].float())
    decoding = ssm_state is not None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                 conv_state if decoding else None)
    xs, B, C = torch.split(xBC, [di, n, n], dim=-1)
    xh = xs.reshape(b, s, hl, hp)
    A = -torch.exp(p["A_log"].float())
    if not decoding:
        y, new_ssm = ssd_chunked(xh, dt, A, B, C, min(cfg.ssm_chunk, s),
                                 impl=impl)
    else:
        new_ssm, new_conv = _step_state(xh, dt, A, B, conv_state, ssm_state,
                                        new_conv, active)
        y = torch.einsum("bhpn,bn->bhp", new_ssm, C[:, 0].float())[:, None]
        y = y.reshape(b, 1, hl, hp).to(dt_c)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(b, s, di) * F.silu(z)
    # ssm_norm over all of d_inner: the squares summed over the ranks
    yf = y.float()
    sq = sum_over_model(torch.square(yf).sum(dim=-1, keepdim=True))
    y = (yf * torch.rsqrt(sq / d_inner + cfg.norm_eps)
         * p["ssm_norm"].float()).to(dt_c)
    out = x + reduce_from_model(torch.matmul(y, p["out_proj"]))
    return out, (new_ssm, new_conv)
