"""RecurrentGemma-9B [arXiv:2402.19427].

38L, d_model 4096, 16 heads (MQA kv=1), d_ff 12288 (GeGLU), vocab 256000.
Griffin pattern: (rec, rec, local-attn) repeating, window 2048.
Sub-quadratic: runs the long_500k decode shape.
"""
from repro_torch.models.config import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, mlp="geglu", head_dim=256,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), window=2048,
                        lru_width=4096, conv_width=4),
    subquadratic=True,
    source="arXiv:2402.19427",
)
