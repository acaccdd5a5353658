"""qwen3-moe-30b-a3b [moe]: 128 routed experts top-8 (hf:Qwen/Qwen3-30B-A3B)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, rope_theta=1_000_000.0,
    num_experts=128, top_k=8, num_shared_experts=0,
)
