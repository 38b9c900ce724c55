"""DeepSeek-V2 236B [arXiv:2405.04434].

60L, d_model 5120, 128 heads, MLA (kv_lora 512, q_lora 1536, rope dim 64),
MoE: 2 shared + 160 routed experts (d_expert 1536), top-6; layer 0 dense
with d_ff 12288.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400, mlp="swiglu", head_dim=128,
    mla=MLAConfig(kv_lora=512, q_lora=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  n_dense_layers=1, dense_d_ff=12288),
    source="arXiv:2405.04434",
)
