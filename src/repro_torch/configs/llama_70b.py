"""Llama-2-70B — the paper's larger evaluation model (§7)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-70b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=32000, mlp="swiglu",
    rope_theta=10_000.0,
    source="arXiv:2307.09288",
)
