"""A ``qwen2`` configuration file as ``repro_torch``'s ModelConfig."""

from __future__ import annotations


def model_config(name: str, conf: dict):
    from repro_torch.models.config import ModelConfig

    if conf["hidden_act"] != "silu" or conf["use_sliding_window"]:
        raise ValueError("the port's Qwen2 runs SwiGLU and full attention")
    return ModelConfig(
        name=name, family="dense", n_layers=conf["num_hidden_layers"],
        d_model=conf["hidden_size"], n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
        qkv_bias=True, mlp="swiglu", rope_theta=conf["rope_theta"],
        norm_eps=conf["rms_norm_eps"],
        tie_embeddings=conf["tie_word_embeddings"])
