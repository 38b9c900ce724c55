"""Qwen2: GQA with q, k, v biases, SwiGLU, RMSNorm, a head tied to the
embedding (counted once, as the head's GEMM)."""

from __future__ import annotations


def active_params(conf: dict) -> int:
    d, L = conf["hidden_size"], conf["num_hidden_layers"]
    H, K = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd, ff, V = d // H, conf["intermediate_size"], conf["vocab_size"]
    attn = d * H * hd + 2 * d * K * hd + H * hd * d + H * hd + 2 * K * hd
    block = attn + 3 * d * ff + 2 * d
    return L * block + d * V + d


def attention(conf: dict):
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    return conf["num_hidden_layers"], H, d // H, d // H
