"""internvl2-26b [vlm]: InternViT + InternLM2 backbone (arXiv:2404.16821).

The ViT frontend is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings occupying the first ``frontend_seq`` positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553, rope_theta=1_000_000.0,
    frontend="vision", frontend_seq=256,
)
