"""Carry parameters of the JAX package over to the port.

This module is the one place where the JAX parameter layout is mapped onto
the port's.  The two layouts are the same tree (see
:mod:`repro_torch.models.model`), so the map is the identity on paths; what
this module adds is the check that every leaf of the source is used exactly
once, with the shape the port expects.  A path is a tuple of dict keys and,
inside a Griffin group's ``subs`` list, list indices
(``("groups", "g0_griffin", "subs", 0, "mixer", "in_x")``).

The map runs both ways: :func:`params_from_jax` and :func:`opt_state_from_jax`
carry a JAX tree over; :func:`params_to_jax` gives a port tree (parameters,
or AdamW's m or v) back in the JAX layout as numpy, leaf for leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.config import ModelConfig
from .models.model import check_ported, griffin_pattern, layer_groups
from .tree import paths

#: leaves the JAX package keeps in fp32 whatever the model dtype
FP32_LEAVES = ("A_log", "dt_bias", "lam")


def path_str(path) -> str:
    return "/".join(map(str, path))


def _attention_shapes(cfg: ModelConfig, L: int) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {("wq",): (L, d, H * hd), ("wk",): (L, d, K * hd),
           ("wv",): (L, d, K * hd), ("wo",): (L, H * hd, d)}
    if cfg.qkv_bias:
        out.update({("bq",): (L, H * hd), ("bk",): (L, K * hd),
                    ("bv",): (L, K * hd)})
    return out


def _mlp_shapes(cfg: ModelConfig, L: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    out = {}
    if cfg.mlp in ("swiglu", "geglu"):
        out[("gate",)] = (L, d, ff)
    out[("up",)] = (L, d, ff)
    out[("down",)] = (L, ff, d)
    return out


def _mamba_shapes(cfg: ModelConfig, L: int) -> dict:
    s, d = cfg.ssm, cfg.d_model
    din, nh = s.d_inner(d), s.n_heads(d)
    conv_ch = din + 2 * s.d_state
    return {("in_proj",): (L, d, 2 * din + 2 * s.d_state + nh),
            ("conv_w",): (L, s.d_conv, conv_ch), ("conv_b",): (L, conv_ch),
            ("A_log",): (L, nh), ("dt_bias",): (L, nh), ("D",): (L, nh),
            ("norm", "w"): (L, din), ("out_proj",): (L, din, d)}


def _recurrent_shapes(cfg: ModelConfig, L: int) -> dict:
    hy, d = cfg.hybrid, cfg.d_model
    w = hy.lru_width or d
    return {("in_x",): (L, d, w), ("in_gate",): (L, d, w),
            ("conv_w",): (L, hy.conv_width, w), ("conv_b",): (L, w),
            ("gate_r",): (L, w, w), ("gate_i",): (L, w, w), ("lam",): (L, w),
            ("out",): (L, w, d)}


def _under(prefix, shapes: dict) -> dict:
    return {prefix + k: v for k, v in shapes.items()}


def param_shapes(cfg: ModelConfig) -> dict[tuple, tuple]:
    """``{path: shape}`` of every leaf of the port's parameters."""
    check_ported(cfg)
    d = cfg.d_model
    out = {("embed",): (cfg.vocab, d)}
    for gi, (kind, L) in enumerate(layer_groups(cfg)):
        g = ("groups", f"g{gi}_{kind}")
        if kind == "dense":
            out[g + ("n1", "w")] = (L, d)
            out.update(_under(g + ("attn",), _attention_shapes(cfg, L)))
            out[g + ("n2", "w")] = (L, d)
            out.update(_under(g + ("mlp",), _mlp_shapes(cfg, L)))
        elif kind == "mamba":
            out[g + ("n1", "w")] = (L, d)
            out.update(_under(g + ("mixer",), _mamba_shapes(cfg, L)))
        else:  # griffin, griffin_tail
            for j, sub in enumerate(griffin_pattern(cfg, kind)):
                sg = g + ("subs", j)
                out[sg + ("n1", "w")] = (L, d)
                mixer = (_recurrent_shapes(cfg, L) if sub == "rec"
                         else _attention_shapes(cfg, L))
                out.update(_under(sg + ("mixer",), mixer))
                out[sg + ("n2", "w")] = (L, d)
                out.update(_under(sg + ("mlp",), _mlp_shapes(cfg, L)))
    out[("final_norm", "w")] = (d,)
    if not cfg.tie_embeddings:
        out[("lm_head",)] = (d, cfg.vocab)
    return out


def _lists(node):
    """Turn the int-keyed dicts built for list paths into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def params_from_jax(tree, cfg: ModelConfig, *, device=None,
                    dtype=torch.float32) -> dict:
    """The port's parameters from a JAX parameter tree given as numpy
    arrays (``{"embed", "groups": {"g0_dense": {...}}, "final_norm"}``,
    layers stacked on a leading axis).  Raises if a leaf is missing, has
    another shape, or is left unused.  The leaves in :data:`FP32_LEAVES`
    stay fp32 whatever ``dtype`` is, as in the JAX package."""
    device = resolve_device(device)
    src = dict(paths(tree))
    params: dict = {}
    for path, shape in param_shapes(cfg).items():
        if path not in src:
            raise ValueError(f"JAX parameters lack {path_str(path)}")
        arr = np.asarray(src.pop(path))
        if arr.shape != shape:
            raise ValueError(f"{path_str(path)}: shape {arr.shape}, "
                             f"expected {shape}")
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        leaf_dtype = torch.float32 if path[-1] in FP32_LEAVES else dtype
        node[path[-1]] = torch.from_numpy(
            arr.astype(np.float32)).to(device=device, dtype=leaf_dtype)
    if src:
        raise ValueError("unused JAX parameters: "
                         + ", ".join(path_str(p) for p in src))
    return _lists(params)


def opt_state_from_jax(state, cfg: ModelConfig, *, device=None) -> dict:
    """The port's AdamW state (:func:`repro_torch.optim.adamw.init_opt_state`)
    from the JAX package's ``{"m", "v", "count"}`` given as numpy: m and v
    through the parameters' path map, all fp32, and ``count`` an int32
    scalar."""
    device = resolve_device(device)
    return {"m": params_from_jax(state["m"], cfg, device=device),
            "v": params_from_jax(state["v"], cfg, device=device),
            "count": torch.tensor(int(np.asarray(state["count"])),
                                  dtype=torch.int32, device=device)}


def params_to_jax(params, cfg: ModelConfig) -> dict:
    """The inverse of :func:`params_from_jax`: a tree of numpy arrays in the
    JAX package's layout (bf16 widened to fp32, which numpy cannot hold),
    from the port's parameters or from AdamW's m or v.  Raises if a leaf is
    missing, has another shape, or is not a parameter."""
    src = dict(paths(params))
    out: dict = {}
    for path, shape in param_shapes(cfg).items():
        if path not in src:
            raise ValueError(f"the port's tree lacks {path_str(path)}")
        t = src.pop(path)
        if tuple(t.shape) != shape:
            raise ValueError(f"{path_str(path)}: shape {tuple(t.shape)}, "
                             f"expected {shape}")
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.detach().to("cpu", torch.float32
                                       if t.dtype == torch.bfloat16
                                       else t.dtype).numpy()
    if src:
        raise ValueError("leaves that are not parameters: "
                         + ", ".join(path_str(p) for p in src))
    return _lists(out)
