"""Model / run configuration system.

Every assigned architecture is a ``ModelConfig`` instance in its own module
(``src/repro_torch/configs/<id>.py``, a copy of the JAX package's registry,
so that both packages build the same configs).  Configs are plain frozen
dataclasses so they are hashable and trivially serializable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# Families understood by the model zoo.
FAMILIES = ("dense", "moe", "enc_dec", "hybrid", "ssm", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES

    # -- transformer backbone ------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    use_bias: bool = False
    tie_embeddings: bool = False

    # -- encoder/decoder (enc_dec family) -------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0

    # -- MoE (moe family) ------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0  # shared-expert FFN width = num_shared * d_ff
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # dispatch groups: routing/capacity is computed per group and the group
    # dim is sharded over 'data', so dispatch gathers are shard-local and
    # the expert reshard is a clean all-to-all (GShard capacity sharding)
    moe_groups: int = 16
    moe_impl: str = "auto"   # 'auto' (explicit-EP when possible) | 'grouped' | 'onehot'

    # -- SSM / Mamba2 (ssm + hybrid families) ----------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256

    # -- hybrid (zamba2 style): a shared-weight attention block applied every
    #    ``attn_every`` SSM layers ------------------------------------------------
    attn_every: int = 0

    # -- modality frontend stubs ----------------------------------------------
    # 'none' | 'vision' (precomputed patch embeddings) | 'audio' (frame embeds)
    frontend: str = "none"
    frontend_seq: int = 0  # number of prepended frontend positions

    # -- numerics ----------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # -- runtime knobs (the paper's technique) -----------------------------------
    num_microbatches: int = 4          # overdecomposition factor for grad accum
    grad_schedule: str = "fused"       # 'fused' | 'overlapped' (C1 analogue)
    grad_reduce_dtype: str = "float32" # 'bfloat16' halves DP all-reduce bytes
    remat: str = "full"                # 'none' | 'full'
    zero1: bool = False                # shard optimizer state over data axis
    flash_block_q: int = 512
    flash_block_kv: int = 512
    attn_impl: str = "auto"            # 'auto' | 'full' | 'blockwise'

    # ----------------------------------------------------------------------------
    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "enc_dec" and self.num_layers == 0:
            object.__setattr__(self, "num_layers", self.enc_layers + self.dec_layers)

    # Derived quantities ----------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 256 so embedding tables always
        shard evenly over the model axis (MaxText-style). Padded logit slots
        are masked to -inf in lm_logits."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid families per the assignment)."""
        return self.family in ("ssm", "hybrid")

    @property
    def expert_capacity_den(self) -> int:
        return max(self.num_experts, 1)

    def reduced(self) -> "ModelConfig":
        """Small config of the same family for CPU smoke tests."""
        kw = dict(
            num_layers=min(self.num_layers, 2) or 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_microbatches=2,
        )
        if self.family == "enc_dec":
            kw.update(enc_layers=2, dec_layers=2, num_layers=0)
        if self.family == "moe":
            kw.update(num_experts=min(self.num_experts, 8) or 8,
                      top_k=min(self.top_k, 2) or 2,
                      num_shared_experts=min(self.num_shared_experts, 1),
                      d_ff=32)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.family == "hybrid":
            kw.update(num_layers=4, attn_every=2)
        if self.frontend != "none":
            kw.update(frontend_seq=8)
        return replace(self, **kw)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned (input-shape) cell: what gets lowered and at what size."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    def reduced(self) -> "ShapeConfig":
        return ShapeConfig(self.name, min(self.seq_len, 64),
                           min(self.global_batch, 4), self.kind)


# The four assigned LM shapes -------------------------------------------------
SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (per assignment)"
    return True, ""
