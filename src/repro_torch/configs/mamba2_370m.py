"""Mamba2-370M [arXiv:2405.21060].

48L, d_model 1024, attention-free SSD (state 128, head_dim 64, expand 2),
vocab 50280.  Sub-quadratic: runs the long_500k decode shape.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=32, n_kv_heads=32,
    d_ff=0, vocab=50280, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    subquadratic=True,
    source="arXiv:2405.21060",
)
