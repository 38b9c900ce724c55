"""DeepSeek-67B [arXiv:2401.02954].

95L, d_model 8192, 64 heads (GQA kv=8), d_ff 22016, vocab 102400.
Llama architecture.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, mlp="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2401.02954",
)
