"""The model stack: the PyTorch counterpart of ``repro/models/model.py``.

Parameters are a plain dict of tensors laid out as the JAX package lays
them out: ``{"embed", "groups": {"g0_dense": {...}}, "final_norm"}``, each
group's leaves stacked on a leading layer axis.  A Griffin group holds
``{"subs": [one dict per sub-block]}``, a list, each leaf stacked over the
superblocks.  Where JAX scans over that axis, the port loops over it in
Python (``layer[i]`` is a view, no copy).  Ported: ``"dense"``, ``"mamba"``
(family ``ssm``) and ``"griffin"`` / ``"griffin_tail"`` (family
``hybrid``) blocks with token inputs; MoE, MLA, M-RoPE and the audio
encoder-decoder raise :class:`NotImplementedError` naming the ROADMAP item
that ports them.  The JAX package's sharding hints are identities without a
mesh and are dropped.

Public entry points:
  init_params(cfg, *, generator, device, dtype)
  forward(params, batch, cfg, remat=False, last_only=False) -> (logits, aux)
  loss_fn(params, batch, cfg, remat=False)     -> (loss, metrics)
  init_decode_state(cfg, batch, max_len, dtype, device)
  decode_step(params, state, batch, cfg)        -> (logits, state)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..tree import tree_leaves, tree_map
from .config import ModelConfig
from .layers import (_init, apply_attention, apply_mlp, init_attention,
                     init_mlp, init_rmsnorm, rms_norm)
from .rglru import apply_recurrent_block, init_recurrent_block
from .ssm import apply_mamba2, init_mamba2

PORTED_KINDS = ("dense", "mamba", "griffin", "griffin_tail")

_WAITING = "ROADMAP queue A, the MoE / MLA / VLM / audio families"


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


def griffin_pattern(cfg: ModelConfig, kind: str) -> tuple[str, ...]:
    """The sub-block kinds of one Griffin block: the whole pattern, or its
    first ``n_layers % len(pattern)`` entries for the tail."""
    pat = cfg.hybrid.pattern
    if kind == "griffin_tail":
        pat = pat[: cfg.n_layers % len(pat)]
    return pat


def check_ported(cfg: ModelConfig) -> None:
    """Raise :class:`NotImplementedError` unless every part of ``cfg`` has
    been ported."""
    for kind, _ in layer_groups(cfg):
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet "
                f"({_WAITING})")
    if cfg.mla or cfg.mrope or cfg.input_kind != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: MLA, M-RoPE and non-token inputs are not ported "
            f"yet ({_WAITING})")


def _layer(stacked, i):
    """Layer ``i`` of a stacked tree: views of the tensors; other leaves
    (a cache's ``idx``) as they are."""
    return tree_map(lambda a: a[i] if torch.is_tensor(a) else a, stacked)


def _layers(stacked) -> list:
    """Every layer of a stacked tree, as :func:`_layer` gives each, cut
    with one ``unbind`` per leaf.  Under autograd a leaf's layer gradients
    then meet in one stack, where ``stacked[i]`` would add a zero-filled
    ``(L, ...)`` gradient per layer."""
    if isinstance(stacked, dict):
        parts = {k: _layers(v) for k, v in stacked.items()}
        return [{k: p[i] for k, p in parts.items()}
                for i in range(_count(stacked))]
    if isinstance(stacked, list):
        parts = [_layers(v) for v in stacked]
        return [[p[i] for p in parts] for i in range(_count(stacked))]
    return list(torch.unbind(stacked))


def _set_layer(stacked, i, tree) -> None:
    """Write the tensors of ``tree`` into layer ``i`` of ``stacked``,
    skipping those that already are that layer's storage."""
    if isinstance(stacked, dict):
        for k, v in stacked.items():
            _set_layer(v, i, tree[k])
    elif isinstance(stacked, list):
        for v, t in zip(stacked, tree):
            _set_layer(v, i, t)
    elif torch.is_tensor(stacked):
        dst = stacked[i]
        if dst.data_ptr() != tree.data_ptr():
            dst.copy_(tree)


def _count(gparams) -> int:
    return tree_leaves(gparams)[0].shape[0]


def init_block(generator, cfg: ModelConfig, kind: str, dtype, device):
    d = cfg.d_model
    if kind == "dense":
        return {"n1": init_rmsnorm(d, dtype, device),
                "attn": init_attention(generator, cfg, dtype, device),
                "n2": init_rmsnorm(d, dtype, device),
                "mlp": init_mlp(generator, d, cfg.d_ff, cfg.mlp, dtype,
                                device)}
    if kind == "mamba":
        return {"n1": init_rmsnorm(d, dtype, device),
                "mixer": init_mamba2(generator, cfg, dtype, device)}
    if kind in ("griffin", "griffin_tail"):
        subs = []
        for sub in griffin_pattern(cfg, kind):
            mixer = (init_recurrent_block(generator, cfg, dtype, device)
                     if sub == "rec"
                     else init_attention(generator, cfg, dtype, device))
            subs.append({"n1": init_rmsnorm(d, dtype, device),
                         "mixer": mixer,
                         "n2": init_rmsnorm(d, dtype, device),
                         "mlp": init_mlp(generator, d, cfg.d_ff, cfg.mlp,
                                         dtype, device)})
        return {"subs": subs}
    raise NotImplementedError(f"block kind {kind!r}: {_WAITING}")


def apply_block(p, x, cfg: ModelConfig, kind: str, ctx: dict, cache=None):
    """Returns (y, new_cache)."""
    eps = cfg.norm_eps
    if kind == "dense":
        y, nc = apply_attention(p["attn"], rms_norm(p["n1"], x, eps), cfg,
                                positions=ctx.get("positions"),
                                causal=ctx.get("causal", True), cache=cache)
        x = x + y
        return x + apply_mlp(p["mlp"], rms_norm(p["n2"], x, eps),
                             cfg.mlp), nc
    if kind == "mamba":
        y, nc = apply_mamba2(p["mixer"], rms_norm(p["n1"], x, eps), cfg,
                             cache)
        return x + y, nc
    if kind in ("griffin", "griffin_tail"):
        new_caches = []
        for j, sub in enumerate(griffin_pattern(cfg, kind)):
            sp = p["subs"][j]
            cj = cache[j] if cache is not None else None
            h = rms_norm(sp["n1"], x, eps)
            if sub == "rec":
                y, nc = apply_recurrent_block(sp["mixer"], h, cfg, cj)
            else:
                y, nc = apply_attention(
                    sp["mixer"], h, cfg, positions=ctx.get("positions"),
                    causal=ctx.get("causal", True),
                    window=cfg.hybrid.window, cache=cj)
            x = x + y
            x = x + apply_mlp(sp["mlp"], rms_norm(sp["n2"], x, eps), cfg.mlp)
            new_caches.append(nc)
        return x, (new_caches if cache is not None else None)
    raise NotImplementedError(f"block kind {kind!r}: {_WAITING}")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, dtype=torch.float32) -> dict:
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for).  Each stacked leaf
    is allocated once, as ``(L, ...)``, and filled layer by layer, so the
    peak is the parameters plus one layer."""
    check_ported(cfg)
    device = resolve_device(device)
    params: dict = {
        "embed": _init(generator, (cfg.vocab, cfg.d_model), dtype, device),
        "groups": {}}
    for gi, (kind, count) in enumerate(layer_groups(cfg)):
        first = init_block(generator, cfg, kind, dtype, device)
        stacked = tree_map(lambda a: a.new_empty((count,) + a.shape), first)
        _set_layer(stacked, 0, first)
        del first
        for i in range(1, count):
            _set_layer(stacked, i,
                       init_block(generator, cfg, kind, dtype, device))
        params["groups"][f"g{gi}_{kind}"] = stacked
    params["final_norm"] = init_rmsnorm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = _init(generator, (cfg.d_model, cfg.vocab), dtype,
                                  device)
    return params


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


def forward(params, batch, cfg: ModelConfig, remat: bool = False,
            last_only: bool = False):
    """Full-sequence forward -> (logits, aux_loss).  ``remat`` keeps only
    each block's input for the backward and runs the block again there
    (``torch.utils.checkpoint``, non-reentrant), as the JAX package wraps
    each scanned block in ``jax.checkpoint``; the kernels then run once in
    the forward and once in the recompute.  ``last_only`` computes the LM
    head on the final position only (prefill serving)."""
    check_ported(cfg)
    x = _embed_inputs(params, batch)
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    ctx = {"positions": positions, "causal": True}
    for gname, gparams in params["groups"].items():
        kind = gname.split("_", 1)[1]

        def blk(x, lp, kind=kind):
            return apply_block(lp, x, cfg, kind, ctx)[0]

        for lp in _layers(gparams):
            if remat:
                x = checkpoint(blk, x, lp, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk(x, lp)
    if last_only:
        x = x[:, -1:, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig, remat: bool = False):
    """Mean next-token cross-entropy over ``loss_mask`` (all ones when the
    batch has none) plus the aux loss -> (loss, {"nll", "aux"}).  As in the
    JAX package, the log-softmax is never formed: fp32 logsumexp minus the
    picked logit, and the mask's sum is kept at least 1."""
    logits, aux = forward(params, batch, cfg, remat=remat)
    labels = batch["labels"].long()
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    picked = torch.gather(logits32, -1, labels[..., None])[..., 0]
    nll = lse - picked
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def _empty_cache_block(cfg: ModelConfig, kind: str, count: int, batch: int,
                       max_len: int, dtype, device):
    """One group's caches, each tensor stacked on a leading layer axis of
    ``count``, as ``repro/models/model.py:_empty_cache_block`` builds them
    (and ``init_decode_state`` stacks them); ``idx`` is a Python int."""
    def zeros(*shape, dt=dtype):
        return torch.zeros((count,) + shape, dtype=dt, device=device)

    d = cfg.d_model
    if kind == "mamba":
        s = cfg.ssm
        return {"conv": zeros(batch, s.d_conv - 1,
                              s.d_inner(d) + 2 * s.d_state),
                "state": zeros(batch, s.n_heads(d), s.head_dim, s.d_state,
                               dt=torch.float32)}
    if kind in ("griffin", "griffin_tail"):
        hy = cfg.hybrid
        w = hy.lru_width or d
        out = []
        for sub in griffin_pattern(cfg, kind):
            if sub == "rec":
                out.append({"conv": zeros(batch, hy.conv_width - 1, w),
                            "h": zeros(batch, w, dt=torch.float32)})
            else:
                wlen = min(hy.window, max_len)
                out.append({"k": zeros(batch, wlen, cfg.n_kv_heads, cfg.hd),
                            "v": zeros(batch, wlen, cfg.n_kv_heads, cfg.hd),
                            "idx": 0})
        return out
    return {"k": zeros(batch, max_len, cfg.n_kv_heads, cfg.hd),
            "v": zeros(batch, max_len, cfg.n_kv_heads, cfg.hd),
            "idx": 0}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.float32, device=None) -> dict:
    """Per-group caches stacked on a leading layer axis, and the step
    counter ``pos``.  Dense: ``{"k", "v": (L, B, max_len, K, hd), "idx"}``.
    Mamba: ``{"conv": (L, B, d_conv-1, d_inner+2n)`` in ``dtype``,
    ``"state": (L, B, heads, head_dim, n)`` fp32``}``.  Griffin: a list, one
    entry per sub-block: ``{"conv", "h"}`` (h fp32) for a recurrent one,
    ``{"k", "v": (L, B, min(window, max_len), K, hd), "idx"}`` for local
    attention."""
    check_ported(cfg)
    device = resolve_device(device)
    caches = {f"g{gi}_{kind}": _empty_cache_block(cfg, kind, count, batch,
                                                  max_len, dtype, device)
              for gi, (kind, count) in enumerate(layer_groups(cfg))}
    return {"caches": caches, "pos": 0}


def _advance(cache, s: int):
    """The group cache with every ``idx`` moved on by ``s``."""
    if isinstance(cache, list):
        return [_advance(c, s) for c in cache]
    if "idx" in cache:
        return {**cache, "idx": cache["idx"] + s}
    return cache


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
            x, nc = apply_block(_layer(gparams, i), x, cfg, kind, ctx,
                                cache=_layer(cache, i))
            _set_layer(cache, i, nc)
        new_caches[gname] = _advance(cache, s)
    return _head(params, x, cfg), {**state, "caches": new_caches,
                                   "pos": pos + 1}
