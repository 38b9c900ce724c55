"""Carry parameters of the JAX package over to the port.

This module is the one place where the JAX parameter layout is mapped onto
the port's.  The two layouts are the same tree (see
:mod:`repro_torch.models.model`), so the map is the identity on paths; what
this module adds is the check that every leaf of the source is used exactly
once, with the shape the port expects.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.config import ModelConfig
from .models.model import check_ported, layer_groups


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def param_shapes(cfg: ModelConfig) -> dict[tuple, tuple]:
    """``{path: shape}`` of every leaf of the port's parameters."""
    check_ported(cfg)
    d, H, K, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    out = {("embed",): (cfg.vocab, d)}
    for gi, (kind, L) in enumerate(layer_groups(cfg)):
        g = ("groups", f"g{gi}_{kind}")
        out[g + ("n1", "w")] = (L, d)
        out[g + ("attn", "wq")] = (L, d, H * hd)
        out[g + ("attn", "wk")] = (L, d, K * hd)
        out[g + ("attn", "wv")] = (L, d, K * hd)
        out[g + ("attn", "wo")] = (L, H * hd, d)
        if cfg.qkv_bias:
            out[g + ("attn", "bq")] = (L, H * hd)
            out[g + ("attn", "bk")] = (L, K * hd)
            out[g + ("attn", "bv")] = (L, K * hd)
        out[g + ("n2", "w")] = (L, d)
        if cfg.mlp in ("swiglu", "geglu"):
            out[g + ("mlp", "gate")] = (L, d, ff)
        out[g + ("mlp", "up")] = (L, d, ff)
        out[g + ("mlp", "down")] = (L, ff, d)
    out[("final_norm", "w")] = (d,)
    if not cfg.tie_embeddings:
        out[("lm_head",)] = (d, cfg.vocab)
    return out


def params_from_jax(tree, cfg: ModelConfig, *, device=None,
                    dtype=torch.float32) -> dict:
    """The port's parameters from a JAX parameter tree given as numpy
    arrays (``{"embed", "groups": {"g0_dense": {...}}, "final_norm"}``,
    layers stacked on a leading axis).  Raises if a leaf is missing, has
    another shape, or is left unused."""
    device = resolve_device(device)
    src = dict(_flatten(tree))
    params: dict = {}
    for path, shape in param_shapes(cfg).items():
        if path not in src:
            raise ValueError(f"JAX parameters lack {'/'.join(path)}")
        arr = np.asarray(src.pop(path))
        if arr.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {shape}")
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.from_numpy(
            arr.astype(np.float32)).to(device=device, dtype=dtype)
    if src:
        raise ValueError("unused JAX parameters: "
                         + ", ".join("/".join(p) for p in src))
    return params
