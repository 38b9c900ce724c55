"""The model stack: the PyTorch counterpart of ``repro/models/model.py``.

Parameters are a plain dict of tensors laid out as the JAX package lays
them out: ``{"embed", "groups": {"g0_dense": {...}}, "final_norm"}``, each
group's leaves stacked on a leading layer axis.  Where JAX scans over that
axis, the port loops over it in Python (``layer[i]`` is a view, no copy).
Only ``"dense"`` blocks with token inputs are ported; the other block kinds
and families raise :class:`NotImplementedError` naming the ROADMAP item
that ports them.  The JAX package's sharding hints are identities without
a mesh and are dropped.

Public entry points:
  init_params(cfg, *, generator, device, dtype)
  forward(params, batch, cfg, last_only=False)  -> (logits, aux)
  init_decode_state(cfg, batch, max_len, dtype, device)
  decode_step(params, state, batch, cfg)        -> (logits, state)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .config import ModelConfig
from .layers import (_init, apply_attention, apply_mlp, init_attention,
                     init_mlp, init_rmsnorm, rms_norm)

_WAITING = {
    "moe": "ROADMAP queue A, the MoE / MLA / VLM / audio families",
    "dec": "ROADMAP queue A, the MoE / MLA / VLM / audio families",
    "mamba": "ROADMAP queue A, mamba2 and recurrentgemma serving (B2, B3)",
    "griffin": "ROADMAP queue A, mamba2 and recurrentgemma serving (B2, B3)",
    "griffin_tail":
        "ROADMAP queue A, mamba2 and recurrentgemma serving (B2, B3)",
}


# ---------------------------------------------------------------------------
# layer groups
# ---------------------------------------------------------------------------

def layer_groups(cfg: ModelConfig) -> list[tuple[str, int]]:
    """(block_kind, count) sequence describing the decoder stack."""
    if cfg.family == "ssm":
        return [("mamba", cfg.n_layers)]
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        n_super, tail = divmod(cfg.n_layers, len(pat))
        groups: list[tuple[str, int]] = [("griffin", n_super)]
        if tail:
            groups.append(("griffin_tail", 1))
        return groups
    if cfg.moe:
        nd = cfg.moe.n_dense_layers
        out = []
        if nd:
            out.append(("dense", nd))
        out.append(("moe", cfg.n_layers - nd))
        return out
    if cfg.encdec:
        return [("dec", cfg.n_layers)]
    return [("dense", cfg.n_layers)]


def check_ported(cfg: ModelConfig) -> None:
    """Raise :class:`NotImplementedError` unless every part of ``cfg`` has
    been ported."""
    for kind, _ in layer_groups(cfg):
        if kind != "dense":
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet "
                f"({_WAITING[kind]})")
    if cfg.mla or cfg.mrope or cfg.input_kind != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: MLA, M-RoPE and non-token inputs are not ported "
            f"yet ({_WAITING['moe']})")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(gparams, i):
    return _tree_map(lambda a: a[i], gparams)


def _count(gparams) -> int:
    return gparams["n1"]["w"].shape[0]


def init_block(generator, cfg: ModelConfig, kind: str, dtype, device):
    if kind != "dense":
        raise NotImplementedError(f"block kind {kind!r}: {_WAITING[kind]}")
    d = cfg.d_model
    return {"n1": init_rmsnorm(d, dtype, device),
            "attn": init_attention(generator, cfg, dtype, device),
            "n2": init_rmsnorm(d, dtype, device),
            "mlp": init_mlp(generator, d, cfg.d_ff, cfg.mlp, dtype, device)}


def apply_block(p, x, cfg: ModelConfig, kind: str, ctx: dict, cache=None):
    """Returns (y, new_cache)."""
    if kind != "dense":
        raise NotImplementedError(f"block kind {kind!r}: {_WAITING[kind]}")
    eps = cfg.norm_eps
    y, nc = apply_attention(p["attn"], rms_norm(p["n1"], x, eps), cfg,
                            positions=ctx.get("positions"),
                            causal=ctx.get("causal", True), cache=cache)
    x = x + y
    return x + apply_mlp(p["mlp"], rms_norm(p["n2"], x, eps), cfg.mlp), nc


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, dtype=torch.float32) -> dict:
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for)."""
    check_ported(cfg)
    device = resolve_device(device)
    params: dict = {
        "embed": _init(generator, (cfg.vocab, cfg.d_model), dtype, device),
        "groups": {}}
    for gi, (kind, count) in enumerate(layer_groups(cfg)):
        layers = [init_block(generator, cfg, kind, dtype, device)
                  for _ in range(count)]
        params["groups"][f"g{gi}_{kind}"] = _stack(layers)
    params["final_norm"] = init_rmsnorm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = _init(generator, (cfg.d_model, cfg.vocab), dtype,
                                  device)
    return params


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed_inputs(params, batch):
    return F.embedding(batch["tokens"], params["embed"])


def _head(params, x, cfg: ModelConfig):
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x @ head


def forward(params, batch, cfg: ModelConfig, last_only: bool = False):
    """Full-sequence forward -> (logits, aux_loss).  ``last_only`` computes
    the LM head on the final position only (prefill serving)."""
    check_ported(cfg)
    x = _embed_inputs(params, batch)
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    ctx = {"positions": positions, "causal": True}
    for gname, gparams in params["groups"].items():
        kind = gname.split("_", 1)[1]
        for i in range(_count(gparams)):
            x, _ = apply_block(_layer(gparams, i), x, cfg, kind, ctx)
    if last_only:
        x = x[:, -1:, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg), aux


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.float32, device=None) -> dict:
    """Per-group KV caches stacked on a leading layer axis, each
    ``{"k", "v": (L, B, max_len, K, hd), "idx": int}``, and the step
    counter ``pos``."""
    check_ported(cfg)
    device = resolve_device(device)
    caches = {}
    for gi, (kind, count) in enumerate(layer_groups(cfg)):
        shape = (count, batch, max_len, cfg.n_kv_heads, cfg.hd)
        caches[f"g{gi}_{kind}"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": 0}
    return {"caches": caches, "pos": 0}


def decode_step(params, state, batch, cfg: ModelConfig):
    """One-token decode.  batch: {tokens: (B, 1)}.  Returns
    (logits (B, 1, V), new_state).  The caches of ``state`` are written in
    place and shared with the new state."""
    pos = state["pos"]
    x = _embed_inputs(params, batch)
    b, s = x.shape[:2]
    ctx = {"positions": torch.full((b, s), pos, device=x.device),
           "causal": True}
    new_caches = {}
    for gname, gparams in params["groups"].items():
        kind = gname.split("_", 1)[1]
        cache = state["caches"][gname]
        for i in range(_count(gparams)):
            c = {"k": cache["k"][i], "v": cache["v"][i], "idx": cache["idx"]}
            x, _ = apply_block(_layer(gparams, i), x, cfg, kind, ctx, cache=c)
        new_caches[gname] = {**cache, "idx": cache["idx"] + s}
    return _head(params, x, cfg), {**state, "caches": new_caches,
                                   "pos": pos + 1}
