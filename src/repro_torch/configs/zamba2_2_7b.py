"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared-weight attention block
applied every 6 layers (arXiv:2411.15242)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, attn_every=6,
)
