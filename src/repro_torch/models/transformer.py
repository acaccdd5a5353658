"""Decoder-only LM (dense / vlm / moe / ssm / hybrid) and
encoder-decoder: parameter schemas, embedding, logits, the stacks.

Port of ``repro.models.transformer``.  ``decoder_forward`` and
``enc_dec_forward`` are the training forwards; the serving paths walk
the layers themselves (``model_zoo``).  Weights keep the reference's
layouts (``wq (d, H, D)``, ``wo (H, D, d)``, ``lm_head (d, V)``), so the
matmuls read the same on both sides.

The frontends are the reference's stubs: a vlm model takes precomputed
``patch_embeds`` in front of its token embeddings, an enc_dec model
takes precomputed ``frames`` as its encoder input.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.launch.sharding import (active_rules, cache_seq_split,
                                         copy_to_model, gather_over_model,
                                         model_axis, model_split,
                                         reduce_from_model, use_rules)
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as ssm_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.schema import Spec


# ============================================================== schemas
def attn_schema(cfg: ModelConfig, stacked: Optional[int], prefix="layers"):
    st = (stacked,) if stacked is not None else ()
    sa = (prefix,) if stacked is not None else ()
    H, KV, D, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "norm": Spec(st + (d,), sa + (None,), "ones"),
        "wq": Spec(st + (d, H, D), sa + ("embed", "heads", "head_dim")),
        "wk": Spec(st + (d, KV, D), sa + ("embed", "kv_heads", "head_dim")),
        "wv": Spec(st + (d, KV, D), sa + ("embed", "kv_heads", "head_dim")),
        "wo": Spec(st + (H, D, d), sa + ("heads", "head_dim", "embed")),
    }


def mlp_schema(cfg: ModelConfig, stacked: Optional[int], prefix="layers"):
    st = (stacked,) if stacked is not None else ()
    sa = (prefix,) if stacked is not None else ()
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": Spec(st + (d,), sa + (None,), "ones"),
        "w_gate": Spec(st + (d, f), sa + ("embed", "ff")),
        "w_up": Spec(st + (d, f), sa + ("embed", "ff")),
        "w_down": Spec(st + (f, d), sa + ("ff", "embed")),
    }


def decoder_lm_schema(cfg: ModelConfig):
    """dense / vlm / moe decoder-only LM."""
    Lc = cfg.num_layers
    sch = {
        "embed": Spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed_tp"),
                      "embed"),
        "final_norm": Spec((cfg.d_model,), (None,), "ones"),
        "layers": {"attn": attn_schema(cfg, Lc)},
    }
    if cfg.family == "moe":
        sch["layers"]["moe"] = moe_lib.moe_schema(cfg, Lc)
    else:
        sch["layers"]["mlp"] = mlp_schema(cfg, Lc)
    if not cfg.tie_embeddings:
        sch["lm_head"] = Spec((cfg.d_model, cfg.padded_vocab),
                              ("embed", "vocab"))
    return sch


def enc_dec_schema(cfg: ModelConfig):
    """The encoder's and the decoder's stacks; ``lm_head`` is always
    there, whatever ``tie_embeddings`` says (as in the reference)."""
    return {
        "embed": Spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed_tp"),
                      "embed"),
        "enc_layers": {
            "attn": attn_schema(cfg, cfg.enc_layers),
            "mlp": mlp_schema(cfg, cfg.enc_layers),
        },
        "enc_norm": Spec((cfg.d_model,), (None,), "ones"),
        "dec_layers": {
            "self_attn": attn_schema(cfg, cfg.dec_layers),
            "cross_attn": attn_schema(cfg, cfg.dec_layers),
            "mlp": mlp_schema(cfg, cfg.dec_layers),
        },
        "final_norm": Spec((cfg.d_model,), (None,), "ones"),
        "lm_head": Spec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab")),
    }


def hybrid_schema(cfg: ModelConfig):
    """zamba2: periods of (attn_every mamba layers + 1 shared attn block)."""
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.num_layers} layers are not whole periods of "
                         f"{cfg.attn_every}")
    periods = cfg.num_layers // cfg.attn_every
    m = ssm_lib.mamba2_schema(cfg, stacked=(periods, cfg.attn_every),
                              prefix=("periods", "stack"))
    shared = {"attn": attn_schema(cfg, None), "mlp": mlp_schema(cfg, None)}
    return {
        "embed": Spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed_tp"),
                      "embed"),
        "final_norm": Spec((cfg.d_model,), (None,), "ones"),
        "mamba": m,
        "shared": shared,
    }


def ssm_lm_schema(cfg: ModelConfig):
    return {
        "embed": Spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed_tp"),
                      "embed"),
        "final_norm": Spec((cfg.d_model,), (None,), "ones"),
        "layers": ssm_lib.mamba2_schema(cfg, stacked=(cfg.num_layers,),
                                        prefix=("layers",)),
    }


def model_schema(cfg: ModelConfig):
    if cfg.family in ("dense", "vlm", "moe"):
        return decoder_lm_schema(cfg)
    if cfg.family == "enc_dec":
        return enc_dec_schema(cfg)
    if cfg.family == "hybrid":
        return hybrid_schema(cfg)
    if cfg.family == "ssm":
        return ssm_lm_schema(cfg)
    raise ValueError(cfg.family)


# ============================================================== embedding / logits
def vocab_block(cfg: ModelConfig):
    """``(first id, ids)`` of this model rank's block of the vocabulary
    where the active rules shard ``vocab`` over a model axis (the
    embedding's rows, ``lm_head``'s columns), else ``None``."""
    n = model_split("vocab", cfg.padded_vocab)
    if n == 1:
        return None
    size = cfg.padded_vocab // n
    return model_axis().rank * size, size


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens (B, S) int -> (B, S, d) in compute dtype (the embedding is
    stored in compute dtype by ``convert``).  With the vocabulary sharded
    over a model axis, the lookup is vocab-parallel: each rank reads its
    rows, ids outside its block give zero rows, and the ranks' rows are
    all-reduced (one nonzero term a token: the whole lookup's bits)."""
    block = vocab_block(cfg)
    if block is None:
        return params["embed"][tokens]
    lo, size = block
    ids = tokens.long() - lo
    inside = (ids >= 0) & (ids < size)
    rows = params["embed"][ids.clamp(0, size - 1)]
    return reduce_from_model(torch.where(inside[..., None], rows,
                                         rows.new_zeros(())))


def lm_logits(params, h: torch.Tensor, cfg: ModelConfig):
    """(B, S, d) -> float32 logits (B, S, padded_vocab), padded slots
    masked to -1e30.  With the vocabulary sharded over a model axis the
    logits stay sharded, as the reference's constraint keeps them
    (``transformer.py:141``): this rank's block of columns, (B, S,
    padded_vocab / model), the mask applied at global column indices
    (``model_zoo.lm_loss`` reduces the cross entropy over the ranks)."""
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].t()
    block = vocab_block(cfg)
    if block is None:
        logits = torch.matmul(h.to(w.dtype), w).float()
        if cfg.padded_vocab != cfg.vocab_size:  # mask padded slots
            logits[..., cfg.vocab_size:] = -1e30
        return logits
    lo, size = block
    logits = torch.matmul(copy_to_model(h.to(w.dtype)), w).float()
    if lo + size > cfg.vocab_size:
        cols = lo + torch.arange(size, device=logits.device)
        logits = torch.where(cols >= cfg.vocab_size, -1e30, logits)
    return logits


# ============================================================== decoder stacks
def _maybe_remat(fn, cfg: ModelConfig):
    """``jax.checkpoint``'s counterpart: with ``cfg.remat == "full"``,
    ``fn`` keeps only its inputs for the backward pass and recomputes its
    insides there.  The recompute replays the same ops, so a kernel
    inside ``fn`` launches once more.  It replays them under the sharding
    rules active at the forward (the rules are thread-local, and the
    backward of CUDA tensors runs on autograd's own thread), so a
    tensor-parallel body recomputes with the same collectives."""
    if cfg.remat != "full":
        return fn

    def remat(*args):
        rules = active_rules()

        def run(*a):
            with use_rules(rules):
                return fn(*a)
        return torch.utils.checkpoint.checkpoint(
            run, *args, use_reentrant=False, preserve_rng_state=False)
    return remat


def prepend_patches(h, patch_embeds):
    """The vision stub: patch embeddings (B, P, d), cast to ``h``'s dtype,
    in front of the token embeddings ``h`` (B, S, d) -> (B, P + S, d);
    positions then count over both."""
    return torch.cat([patch_embeds.to(h.dtype), h], dim=1)


def decoder_forward(params, tokens, cfg: ModelConfig, *,
                    patch_embeds=None, impl: str = "kernel"):
    """tokens (B, S) -> (final hidden states (B, S', d), aux_total).

    ``params`` is in the eager layout (``convert.compute_view`` of a
    training state, or serving params).  A vlm model takes
    ``patch_embeds`` (B, frontend_seq, d) in front of its tokens, so
    S' = frontend_seq + S; S' = S otherwise.  ``aux_total`` (float32)
    sums the MoE blocks' aux losses; 0 for the other families.  Remat
    wraps the reference's bodies: each layer (dense, vlm, moe, ssm), each
    period of the hybrid (its Mamba2 layers, then the shared attention
    and MLP).  ``impl`` goes to ``mamba2_block`` only (``"ref"``: the
    plain SSD on the card)."""
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
        raise ValueError(cfg.family)
    h = embed_tokens(params, tokens, cfg)
    if cfg.frontend == "vision":
        if patch_embeds is None:
            raise ValueError(f"{cfg.name} takes patch_embeds")
        h = prepend_patches(h, patch_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family in ("dense", "vlm", "moe"):
        def body(x, aux_acc, lp):
            x, _ = L.attention_block(lp["attn"], x, cfg, causal=True)
            if cfg.family == "moe":
                x, aux = moe_lib.moe_block(lp["moe"], x, cfg)
                aux_acc = aux_acc + aux
            else:
                x = L.swiglu_block(lp["mlp"], x, cfg)
            return x, aux_acc
        body = _maybe_remat(body, cfg)
        for lp in params["layers"]:
            h, aux_total = body(h, aux_total, lp)
    elif cfg.family == "ssm":
        def body(x, lp):
            return ssm_lib.mamba2_block(lp, x, cfg, impl=impl)[0]
        body = _maybe_remat(body, cfg)
        for lp in params["layers"]:
            h = body(h, lp)
    else:
        shared = params["shared"]

        def period_body(x, period):
            for lp in period:
                x = ssm_lib.mamba2_block(lp, x, cfg, impl=impl)[0]
            x, _ = L.attention_block(shared["attn"], x, cfg, causal=True)
            return L.swiglu_block(shared["mlp"], x, cfg)
        period_body = _maybe_remat(period_body, cfg)
        for period in params["mamba"]:
            h = period_body(h, period)
    return h, aux_total


def encoder_forward(params, frames, cfg: ModelConfig, *,
                    impl: str = "kernel"):
    """The audio stub's frames (B, S, d), cast to the compute dtype, through
    the encoder: each layer a non-causal ``attention_block`` (rotary over
    the frame positions; ``blockwise_attention`` past 8192 frames, the
    flash kernel on the card) and a SwiGLU MLP, then ``enc_norm``.
    Remat wraps each layer.  ``impl`` goes to ``attention_block``
    (``"ref"``: the plain blockwise form on the card).  Under rules with
    a model axis the blocks are tensor parallel (``layers``) and the
    frames and the output stay replicated over it."""
    h = frames.to(dtype_of(cfg.compute_dtype))

    def body(x, lp):
        x, _ = L.attention_block(lp["attn"], x, cfg, causal=False, impl=impl)
        return L.swiglu_block(lp["mlp"], x, cfg)
    body = _maybe_remat(body, cfg)
    for lp in params["enc_layers"]:
        h = body(h, lp)
    return L.rms_norm(h, params["enc_norm"], cfg.norm_eps)


def cross_kv_heads(p, enc_out, cfg: ModelConfig):
    """Cross attention's k and v (B, S_enc, heads, D) from the encoder
    output, projections only, no rotary, of the KV heads this rank holds,
    and the KV head each of its query heads reads (``None``: local), as
    ``layers.kv_heads_tp`` gives them: where the active rules shard
    ``heads`` over a model axis, the encoder output (replicated over it)
    goes through f (``copy_to_model``) and the projections are
    column-parallel; f's backward sums the ranks' partial gradients of
    the encoder output, once for each decoder layer that reads it.  A
    decode state's ``xk``/``xv`` keep these heads
    (``layers.cache_block``)."""
    e = enc_out.to(dtype_of(cfg.compute_dtype))
    if model_split("heads", cfg.num_heads) > 1:
        return L.kv_heads_tp(p, copy_to_model(e), cfg)
    return L._proj(e, p["wk"]), L._proj(e, p["wv"]), None


def cross_kv(p, enc_out, cfg: ModelConfig):
    """``cross_kv_heads``' k and v of each of this rank's query heads
    (``layers.expand_kv``)."""
    return L.expand_kv(*cross_kv_heads(p, enc_out, cfg))


def cross_attention(p, x, xk, xv, cfg: ModelConfig):
    """x (B, S, d) attends to all of ``xk``/``xv`` (B, S_enc, KV, D): an
    RMS-normed q (no rotary) through ``full_attention(causal=False)``,
    at any length (the reference never takes it blockwise), plus the
    residual.  Tensor parallel as ``attention_block`` is where the rules
    shard ``heads``: f on the normed input, q over this rank's heads
    (``xk``/``xv`` are its heads' from ``cross_kv``), ``wo``
    row-parallel and g in the block's dtype."""
    dt = dtype_of(cfg.compute_dtype)
    tp = model_split("heads", cfg.num_heads) > 1
    hn = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    att = L.full_attention(L._proj(copy_to_model(hn) if tp else hn, p["wq"]),
                           xk.to(dt), xv.to(dt), causal=False)
    out = L._proj_out(att, p["wo"])
    return x + (reduce_from_model(out) if tp else out)


def decode_cross_attention(p, x, xk, xv, cfg: ModelConfig):
    """A decode step's cross attention over a decode state's ``xk``/``xv``:
    ``cross_attention`` without a model axis.  Under rules with a model
    axis above 1 they are this rank's block of the reference's layout,
    as the self attention's cache is (``layers.decode_attention``).
    Where the axis divides the cache's positions
    (``sharding.cache_seq_split``): positions ``[r S/m, (r+1) S/m)`` of
    every KV head; q of the rank's query heads (f on the normed input,
    no rotary), gathered over the model group where the rules shard
    ``heads``, then ``layers.seq_sharded_attention`` with no mask (the
    reference attends to all of the encoder's positions), and the rank's
    heads through ``wo`` and g (every head through the whole ``wo``
    where ``heads`` is replicated).  Otherwise every position of the KV
    heads the rank holds: ``cross_attention`` on the rank's query heads,
    each reading its KV head (``layers.kv_index``), as the prefill's
    cross attention does."""
    tp = model_axis()
    if tp is None:
        return cross_attention(p, x, xk, xv, cfg)
    dt = dtype_of(cfg.compute_dtype)
    if not cache_seq_split():
        return cross_attention(p, x, *L.expand_kv(
            xk.to(dt), xv.to(dt), L.kv_index(cfg, x.device)), cfg)
    tp_heads = model_split("heads", cfg.num_heads) > 1
    hn = L.rms_norm(x, p["norm"], cfg.norm_eps).to(dt)
    q = L._proj(copy_to_model(hn) if tp_heads else hn, p["wq"])
    if tp_heads:
        q = gather_over_model(q, 2)
    att = L.seq_sharded_attention(q, xk.to(dt), xv.to(dt)).to(dt)
    if not tp_heads:
        return x + L._proj_out(att, p["wo"])
    n = cfg.num_heads // tp.size
    out = L._proj_out(att.narrow(2, tp.rank * n, n), p["wo"])
    return x + reduce_from_model(out)


def enc_dec_forward(params, frames, tokens, cfg: ModelConfig, *,
                    impl: str = "kernel"):
    """frames (B, S_enc, d), tokens (B, S) -> the decoder's final hidden
    states (B, S, d).  Each decoder layer: causal self attention, cross
    attention over the encoder output, SwiGLU MLP; remat wraps each layer
    (and each encoder layer).  ``impl`` as in ``encoder_forward``."""
    enc_out = encoder_forward(params, frames, cfg, impl=impl)
    h = embed_tokens(params, tokens, cfg)

    def body(x, enc, lp):
        x, _ = L.attention_block(lp["self_attn"], x, cfg, causal=True,
                                 impl=impl)
        x = cross_attention(lp["cross_attn"], x,
                            *cross_kv(lp["cross_attn"], enc, cfg), cfg)
        return L.swiglu_block(lp["mlp"], x, cfg)
    body = _maybe_remat(body, cfg)
    for lp in params["dec_layers"]:
        h = body(h, enc_out, lp)
    return h
