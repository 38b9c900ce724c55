"""Qwen2-VL-72B language backbone [arXiv:2409.12191].

80L, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064.
M-RoPE (3-section t/h/w positions); the ViT vision encoder is a stub —
input_specs() supplies interleaved patch/text embeddings directly.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0, mrope=True, mlp="swiglu",
    input_kind="embeds",
    source="arXiv:2409.12191",
)
