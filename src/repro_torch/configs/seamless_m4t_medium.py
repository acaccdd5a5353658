"""seamless-m4t-medium [audio]: encoder-decoder (arXiv:2308.11596).

Audio frontend is a STUB: input_specs() supplies precomputed frame embeddings
as the encoder input sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="enc_dec",
    enc_layers=12, dec_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, frontend="audio",
)
