"""Qwen2-1.5B [arXiv:2407.10671].

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936, QKV bias.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, qkv_bias=True, mlp="swiglu",
    rope_theta=1_000_000.0, tie_embeddings=True,
    source="arXiv:2407.10671",
)
