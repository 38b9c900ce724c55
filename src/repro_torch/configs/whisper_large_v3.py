"""Whisper large-v3 [arXiv:2212.04356].

Encoder-decoder; 32 decoder layers (+32 encoder), d_model 1280, 20 heads
(no GQA), d_ff 5120, vocab 51866.  The mel-spectrogram + conv frontend is
a stub: input_specs() supplies 1500 precomputed frame embeddings.
LayerNorm + GELU (family "audio" switches the norm/activation).
"""
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, mlp="gelu",
    encdec=EncDecConfig(n_enc_layers=32, n_frames=1500),
    input_kind="audio",
    source="arXiv:2212.04356",
)
