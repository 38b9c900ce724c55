"""Llama-architecture 32B — the paper's own evaluation model (§7)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-32b", family="dense",
    n_layers=60, d_model=6656, n_heads=52, n_kv_heads=52,
    d_ff=17920, vocab=32000, mlp="swiglu", head_dim=128,
    rope_theta=10_000.0,
    source="arXiv:2307.09288 (paper §7 scale)",
)
