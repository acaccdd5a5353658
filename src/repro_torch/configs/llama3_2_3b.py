"""llama3.2-3b [dense]: small llama3 (hf:meta-llama/Llama-3.2-*).

24 q-heads do not divide the 16-way model axis: attention projections fall
back to replicated sharding (see launch/sharding.py) -- noted in roofline.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256, rope_theta=500_000.0,
)
