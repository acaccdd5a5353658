"""Decoder-only LM: parameter schemas, embedding, logits, the stack.

Port of ``repro.models.transformer`` for the dense, moe, ssm and hybrid
families.  ``decoder_forward`` is the training forward; the serving
paths walk the layers themselves (``model_zoo``).  Weights keep the
reference's layouts (``wq (d, H, D)``, ``wo (H, D, d)``, ``lm_head (d,
V)``), so the matmuls read the same on both sides.  The enc_dec and vlm
families raise ``NotImplementedError`` (ROADMAP item 11).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as ssm_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.schema import Spec


def _not_ported(cfg: ModelConfig):
    return NotImplementedError(
        f"family {cfg.family!r} is not ported yet: enc_dec and vlm are "
        f"ROADMAP item 11")


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
    """dense / moe decoder-only LM."""
    if cfg.family not in ("dense", "moe"):
        raise _not_ported(cfg)
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
    if cfg.family in ("dense", "moe"):
        return decoder_lm_schema(cfg)
    if cfg.family == "hybrid":
        return hybrid_schema(cfg)
    if cfg.family == "ssm":
        return ssm_lm_schema(cfg)
    raise _not_ported(cfg)


# ============================================================== embedding / logits
def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens (B, S) int -> (B, S, d) in compute dtype (the embedding is
    stored in compute dtype by ``convert``)."""
    return params["embed"][tokens]


def lm_logits(params, h: torch.Tensor, cfg: ModelConfig):
    """(B, S, d) -> float32 logits (B, S, padded_vocab), padded slots
    masked to -1e30."""
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].t()
    logits = torch.matmul(h.to(w.dtype), w).float()
    if cfg.padded_vocab != cfg.vocab_size:  # mask padded slots
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# ============================================================== decoder stacks
def _maybe_remat(fn, cfg: ModelConfig):
    """``jax.checkpoint``'s counterpart: with ``cfg.remat == "full"``,
    ``fn`` keeps only its inputs for the backward pass and recomputes its
    insides there.  The recompute replays the same ops, so a kernel
    inside ``fn`` launches once more."""
    if cfg.remat != "full":
        return fn

    def remat(*args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return remat


def decoder_forward(params, tokens, cfg: ModelConfig, *,
                    impl: str = "kernel"):
    """tokens (B, S) -> (final hidden states (B, S, d), aux_total).

    ``params`` is in the eager layout (``convert.compute_view`` of a
    training state, or serving params).  ``aux_total`` (float32) sums the
    MoE blocks' aux losses; 0 for the other families.  Remat wraps the
    reference's bodies: each layer (dense, moe, ssm), each period of the
    hybrid (its Mamba2 layers, then the shared attention and MLP).
    ``impl`` goes to ``mamba2_block`` only (``"ref"``: the plain SSD on
    the card)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise _not_ported(cfg)
    h = embed_tokens(params, tokens, cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family in ("dense", "moe"):
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
