"""Qwen2 [arXiv:2407.10671]: a dense decoder of pre-norm blocks, GQA with
biased q, k and v projections and rotary positions, a SwiGLU MLP, RMSNorm,
and an output head tied to the embedding.

The weights come as one tree of matrices laid out (in, out), each leaf of
the decoder stacked over the layers under ``groups/g0_dense``."""

from __future__ import annotations

import torch.nn.functional as F

from .common import (causal_attention, layer, masked_nll, rms_norm, rope,
                     run_block, swiglu)


def param_shapes(conf: dict) -> dict:
    """The weight tree: leaf -> (shape, init), init one of ``normal``,
    ``ones``, ``zeros``."""
    L, d = conf["num_hidden_layers"], conf["hidden_size"]
    H, K = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd, ff, V = d // H, conf["intermediate_size"], conf["vocab_size"]
    block = {
        "n1": {"w": ((L, d), "ones")},
        "attn": {"wq": ((L, d, H * hd), "normal"),
                 "wk": ((L, d, K * hd), "normal"),
                 "wv": ((L, d, K * hd), "normal"),
                 "wo": ((L, H * hd, d), "normal"),
                 "bq": ((L, H * hd), "zeros"),
                 "bk": ((L, K * hd), "zeros"),
                 "bv": ((L, K * hd), "zeros")},
        "n2": {"w": ((L, d), "ones")},
        "mlp": {"gate": ((L, d, ff), "normal"), "up": ((L, d, ff), "normal"),
                "down": ((L, ff, d), "normal")},
    }
    tree = {"embed": ((V, d), "normal"), "groups": {"g0_dense": block},
            "final_norm": {"w": ((d,), "ones")}}
    if not conf["tie_word_embeddings"]:
        tree["lm_head"] = ((d, V), "normal")
    return tree


def _block(conf, positions):
    H, K = conf["num_attention_heads"], conf["num_key_value_heads"]
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]

    def block(x, p):
        b, s, d = x.shape
        hd = d // H
        a = p["attn"]
        h = rms_norm(x, p["n1"]["w"], eps)
        q = (h @ a["wq"] + a["bq"]).reshape(b, s, H, hd)
        k = (h @ a["wk"] + a["bk"]).reshape(b, s, K, hd)
        v = (h @ a["wv"] + a["bv"]).reshape(b, s, K, hd)
        o = causal_attention(rope(q, positions, theta),
                             rope(k, positions, theta), v)
        x = x + o.reshape(b, s, H * hd) @ a["wo"]
        h = rms_norm(x, p["n2"]["w"], eps)
        m = p["mlp"]
        return x + swiglu(h, m["gate"], m["up"], m["down"])

    return block


def loss(params: dict, batch: dict, conf: dict, remat: bool = True):
    """Mean next-token cross-entropy of one microbatch."""
    x = F.embedding(batch["tokens"].long(), params["embed"])
    block = _block(conf, batch["positions"])
    stack = params["groups"]["g0_dense"]
    for i in range(conf["num_hidden_layers"]):
        x = run_block(block, x, layer(stack, i), remat)
    x = rms_norm(x, params["final_norm"]["w"], conf["rms_norm_eps"])
    head = params.get("lm_head")
    logits = x @ (params["embed"].T if head is None else head)
    return masked_nll(logits, batch["labels"], batch["loss_mask"])
