"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + 4 shared
(hf:Qwen/Qwen1.5-MoE-A2.7B). 60 % 16 != 0 -> EP fallback shards expert d_ff.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151936,
    num_experts=60, top_k=4, num_shared_experts=4,
)
