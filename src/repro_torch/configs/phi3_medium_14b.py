"""Phi-3-medium 14B [arXiv:2404.14219].

40L, d_model 5120, 40 heads (GQA kv=10), d_ff 17920, vocab 100352.
RoPE + SwiGLU + GQA.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab=100352, mlp="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2404.14219",
)
