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
:func:`cast_params` casts a port tree to another type under the JAX
package's rule (:data:`FP32_LEAVES` stay fp32).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.config import ModelConfig
from .models.model import dense_d_ff, griffin_pattern, layer_groups
from .tree import paths, unflatten_like

#: leaves the JAX package keeps in fp32 whatever the model dtype
FP32_LEAVES = ("A_log", "dt_bias", "lam")


def path_str(path) -> str:
    return "/".join(map(str, path))


def _norm_shapes(cfg: ModelConfig, *lead) -> dict:
    """RMSNorm's ``w``; LayerNorm (family ``audio``) adds ``b``."""
    out = {("w",): (*lead, cfg.d_model)}
    if cfg.family == "audio":
        out[("b",)] = (*lead, cfg.d_model)
    return out


def _attention_shapes(cfg: ModelConfig, L: int, cross: bool = False) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {("wq",): (L, d, H * hd), ("wk",): (L, d, K * hd),
           ("wv",): (L, d, K * hd), ("wo",): (L, H * hd, d)}
    if cfg.qkv_bias and not cross:
        out.update({("bq",): (L, H * hd), ("bk",): (L, K * hd),
                    ("bv",): (L, K * hd)})
    return out


def _mla_shapes(cfg: ModelConfig, L: int) -> dict:
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    out = ({("wq_a",): (L, d, m.q_lora), ("wq_b",): (L, m.q_lora, H * qd)}
           if m.q_lora else {("wq",): (L, d, H * qd)})
    out.update({("wkv_a",): (L, d, m.kv_lora + m.qk_rope_dim),
                ("wkv_b",): (L, m.kv_lora, H * (m.qk_nope_dim + m.v_head_dim)),
                ("wo",): (L, H * m.v_head_dim, d)})
    return out


def _mlp_shapes(cfg: ModelConfig, *lead, ff: int | None = None,
                kind: str | None = None) -> dict:
    """An MLP's leaves under the leading dims ``lead`` (layers, and
    experts for an MoE), of width ``ff`` (``d_ff``) and ``kind``
    (``cfg.mlp``)."""
    d = cfg.d_model
    ff = cfg.d_ff if ff is None else ff
    out = {}
    if (kind or cfg.mlp) in ("swiglu", "geglu"):
        out[("gate",)] = (*lead, d, ff)
    out[("up",)] = (*lead, d, ff)
    out[("down",)] = (*lead, ff, d)
    return out


def _moe_shapes(cfg: ModelConfig, L: int) -> dict:
    m = cfg.moe
    out = {("router",): (L, cfg.d_model, m.n_experts)}
    out.update(_under(("experts",), _mlp_shapes(cfg, L, m.n_experts,
                                                ff=m.d_expert)))
    if m.n_shared:
        out.update(_under(("shared",), _mlp_shapes(cfg, L, m.n_shared,
                                                   ff=m.d_expert)))
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


def _block_shapes(cfg: ModelConfig, kind: str, L: int) -> dict:
    """The leaves of ``L`` stacked blocks of ``kind``."""
    out = _under(("n1",), _norm_shapes(cfg, L))
    if kind in ("dense", "moe"):
        out.update(_under(("attn",), _mla_shapes(cfg, L) if cfg.mla
                          else _attention_shapes(cfg, L)))
        out.update(_under(("n2",), _norm_shapes(cfg, L)))
        out.update(_under(("moe",), _moe_shapes(cfg, L)) if kind == "moe"
                   else _under(("mlp",), _mlp_shapes(cfg, L,
                                                     ff=dense_d_ff(cfg))))
    elif kind == "mamba":
        out.update(_under(("mixer",), _mamba_shapes(cfg, L)))
    elif kind in ("enc", "dec"):
        out.update(_under(("attn",), _attention_shapes(cfg, L)))
        if kind == "dec":
            out.update(_under(("nx",), _norm_shapes(cfg, L)))
            out.update(_under(("xattn",), _attention_shapes(cfg, L,
                                                            cross=True)))
        out.update(_under(("n2",), _norm_shapes(cfg, L)))
        out.update(_under(("mlp",), _mlp_shapes(cfg, L, kind="gelu")))
    else:  # griffin, griffin_tail
        out = {}
        for j, sub in enumerate(griffin_pattern(cfg, kind)):
            mixer = (_recurrent_shapes(cfg, L) if sub == "rec"
                     else _attention_shapes(cfg, L))
            out.update(_under(("subs", j, "n1"), _norm_shapes(cfg, L)))
            out.update(_under(("subs", j, "mixer"), mixer))
            out.update(_under(("subs", j, "n2"), _norm_shapes(cfg, L)))
            out.update(_under(("subs", j, "mlp"), _mlp_shapes(cfg, L)))
    return out


def param_shapes(cfg: ModelConfig) -> dict[tuple, tuple]:
    """``{path: shape}`` of every leaf of the port's parameters."""
    d = cfg.d_model
    out = {}
    if cfg.input_kind == "tokens" or cfg.encdec:
        out[("embed",)] = (cfg.vocab, d)
    for gi, (kind, L) in enumerate(layer_groups(cfg)):
        out.update(_under(("groups", f"g{gi}_{kind}"),
                          _block_shapes(cfg, kind, L)))
    if cfg.encdec:
        out.update(_under(("encoder",), _block_shapes(
            cfg, "enc", cfg.encdec.n_enc_layers)))
        out.update(_under(("enc_norm",), _norm_shapes(cfg)))
    out.update(_under(("final_norm",), _norm_shapes(cfg)))
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


def cast_params(params, dtype) -> dict:
    """The port's parameters in ``dtype``, the leaves in
    :data:`FP32_LEAVES` kept fp32, as the JAX package's ``init_params(key,
    cfg, dtype)`` makes them."""
    leaves = [leaf if path[-1] in FP32_LEAVES else leaf.to(dtype)
              for path, leaf in paths(params)]
    return unflatten_like(params, leaves)


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
