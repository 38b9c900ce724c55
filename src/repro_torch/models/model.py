"""The model stack: the PyTorch counterpart of ``repro/models/model.py``.

Parameters are a plain dict of tensors laid out as the JAX package lays
them out: ``{"embed", "groups": {"g0_dense": {...}}, "final_norm"}``, each
group's leaves stacked on a leading layer axis.  A Griffin group holds
``{"subs": [one dict per sub-block]}``, a list, each leaf stacked over the
superblocks.  Where JAX scans over that axis, the port loops over it in
Python (``layer[i]`` is a view, no copy).  Every block kind of the JAX
package is here: ``"dense"`` (GQA or MLA attention), ``"moe"``,
``"mamba"`` (family ``ssm``), ``"griffin"`` / ``"griffin_tail"`` (family
``hybrid``) and the audio encoder-decoder's ``"enc"`` / ``"dec"`` (family
``audio``: LayerNorm, GELU, no RoPE, cross-attention to the encoder's
output).  Inputs are tokens, embeddings (``input_kind == "embeds"``: no
embedding table, M-RoPE ``positions3``) or tokens with audio frames
(``"audio"``).  The sharding hints sit where the JAX package has them
(:mod:`repro_torch.sharding.hints`): identities without an active mesh
or on plain tensors.  Under the dry run's DTensor mesh each block's, the
embedding's and the head's weights are also gathered over the batch axes
where they are used (FSDP, ``hints.gather_weights``).

Public entry points:
  init_params(cfg, *, generator, device, dtype)
  forward(params, batch, cfg, remat=False, last_only=False) -> (logits, aux)
  loss_fn(params, batch, cfg, remat=False)     -> (loss, metrics)
  init_decode_state(cfg, batch, max_len, dtype, device, enc_out=None)
  decode_step(params, state, batch, cfg)        -> (logits, state)
"""

from __future__ import annotations

import math
from contextlib import nullcontext

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..sharding.hints import (batch_axes, gather_weights, hint, is_dtensor,
                              pin_residual, shardwise)
from ..spans import REMAT, span
from ..tree import tree_leaves, tree_map
from .config import ModelConfig
from .layers import (_init, apply_attention, apply_mla, apply_mlp,
                     init_attention, init_layernorm, init_mla, init_mlp,
                     init_rmsnorm, layer_norm, rms_norm)
from .moe import apply_moe, init_moe
from .rglru import apply_recurrent_block, init_recurrent_block
from .ssm import apply_mamba2, init_mamba2


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


def _norm_init(cfg: ModelConfig):
    return init_layernorm if cfg.family == "audio" else init_rmsnorm


def _norm_apply(cfg: ModelConfig):
    return layer_norm if cfg.family == "audio" else rms_norm


def dense_d_ff(cfg: ModelConfig) -> int:
    """The MLP width of a ``"dense"`` block: an MoE config's
    ``dense_d_ff`` where it has one, else ``d_ff``."""
    return cfg.moe.dense_d_ff if cfg.moe and cfg.moe.dense_d_ff else cfg.d_ff


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
    ninit = _norm_init(cfg)

    def norm():
        return ninit(d, dtype, device)

    def attention(**kw):
        return init_attention(generator, cfg, dtype, device, **kw)

    def mlp(ff, kind_=cfg.mlp):
        return init_mlp(generator, d, ff, kind_, dtype, device)

    if kind in ("dense", "moe"):
        attn = (init_mla(generator, cfg, dtype, device) if cfg.mla
                else attention())
        out = {"n1": norm(), "attn": attn, "n2": norm()}
        if kind == "moe":
            out["moe"] = init_moe(generator, cfg, dtype, device)
        else:
            out["mlp"] = mlp(dense_d_ff(cfg))
        return out
    if kind == "mamba":
        return {"n1": norm(), "mixer": init_mamba2(generator, cfg, dtype,
                                                   device)}
    if kind in ("griffin", "griffin_tail"):
        subs = []
        for sub in griffin_pattern(cfg, kind):
            mixer = (init_recurrent_block(generator, cfg, dtype, device)
                     if sub == "rec" else attention())
            subs.append({"n1": norm(), "mixer": mixer, "n2": norm(),
                         "mlp": mlp(cfg.d_ff)})
        return {"subs": subs}
    if kind == "enc":
        return {"n1": norm(), "attn": attention(), "n2": norm(),
                "mlp": mlp(cfg.d_ff, "gelu")}
    if kind == "dec":
        return {"n1": norm(), "attn": attention(), "nx": norm(),
                "xattn": attention(cross=True), "n2": norm(),
                "mlp": mlp(cfg.d_ff, "gelu")}
    raise ValueError(kind)


def apply_block(p, x, cfg: ModelConfig, kind: str, ctx: dict, cache=None):
    """Returns (y, new_cache, aux); aux is the MoE block's load-balance
    loss (fp32 scalar), None for every other block."""
    napp = _norm_apply(cfg)
    eps = cfg.norm_eps
    aux = None
    p = gather_weights(p)

    def attn_call(ap, h, *, window=None, cross=False, c=None):
        if cfg.mla and not cross:
            return apply_mla(ap, h, cfg, positions=ctx.get("positions"),
                             cache=c)
        return apply_attention(
            ap, h, cfg, positions=ctx.get("positions"),
            positions3=ctx.get("positions3"),
            causal=False if cross else ctx.get("causal", True),
            window=window, cache=c,
            kv_src=ctx.get("enc_out") if cross else None,
            use_rope=not cross and cfg.family != "audio")

    if kind in ("dense", "moe"):
        y, nc = attn_call(p["attn"], napp(p["n1"], x, eps), c=cache)
        x = pin_residual(x + y)
        h = napp(p["n2"], x, eps)
        if kind == "moe":
            y2, aux = apply_moe(p["moe"], h, cfg)
        else:
            y2 = apply_mlp(p["mlp"], h, cfg.mlp)
        return pin_residual(x + y2), nc, aux
    if kind == "mamba":
        y, nc = apply_mamba2(p["mixer"], napp(p["n1"], x, eps), cfg, cache)
        return pin_residual(x + y), nc, aux
    if kind in ("griffin", "griffin_tail"):
        new_caches = []
        for j, sub in enumerate(griffin_pattern(cfg, kind)):
            sp = p["subs"][j]
            cj = cache[j] if cache is not None else None
            h = napp(sp["n1"], x, eps)
            if sub == "rec":
                y, nc = apply_recurrent_block(sp["mixer"], h, cfg, cj)
            else:
                y, nc = attn_call(sp["mixer"], h, window=cfg.hybrid.window,
                                  c=cj)
            x = pin_residual(x + y)
            x = pin_residual(
                x + apply_mlp(sp["mlp"], napp(sp["n2"], x, eps), cfg.mlp))
            new_caches.append(nc)
        return x, (new_caches if cache is not None else None), aux
    if kind == "enc":
        y, _ = apply_attention(p["attn"], napp(p["n1"], x, eps), cfg,
                               causal=False, use_rope=False)
        x = pin_residual(x + y)
        return pin_residual(
            x + apply_mlp(p["mlp"], napp(p["n2"], x, eps), "gelu")), \
            None, aux
    if kind == "dec":
        c_self = cache["self"] if cache is not None else None
        y, nc = attn_call(p["attn"], napp(p["n1"], x, eps), c=c_self)
        x = pin_residual(x + y)
        yx, _ = attn_call(p["xattn"], napp(p["nx"], x, eps), cross=True)
        x = pin_residual(x + yx)
        x = pin_residual(x + apply_mlp(p["mlp"], napp(p["n2"], x, eps),
                                       "gelu"))
        return x, ({"self": nc} if nc is not None else None), aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _shapes_only(device) -> bool:
    """On the ``meta`` device (shapes without storage) a stack is not
    filled layer by layer: its shape is all there is."""
    return torch.device(device).type == "meta"


def _init_stack(generator, cfg: ModelConfig, kind: str, count: int, dtype,
                device):
    """``count`` blocks of ``kind``, each leaf stacked on a leading axis:
    allocated once as ``(count, ...)`` and filled block by block."""
    first = init_block(generator, cfg, kind, dtype, device)
    stacked = tree_map(lambda a: a.new_empty((count,) + a.shape), first)
    if _shapes_only(device):
        return stacked
    _set_layer(stacked, 0, first)
    del first
    for i in range(1, count):
        _set_layer(stacked, i, init_block(generator, cfg, kind, dtype,
                                          device))
    return stacked


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, dtype=torch.float32) -> dict:
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for).  Each stacked leaf
    is allocated once, as ``(L, ...)``, and filled layer by layer, so the
    peak is the parameters plus one layer.  A config with embedding inputs
    has no ``embed`` table; an encoder-decoder adds ``encoder`` (stacked
    ``"enc"`` blocks) and ``enc_norm``."""
    device = resolve_device(device)
    ninit = _norm_init(cfg)
    params: dict = {}
    if cfg.input_kind == "tokens" or cfg.encdec:
        params["embed"] = _init(generator, (cfg.vocab, cfg.d_model), dtype,
                                device)
    params["groups"] = {
        f"g{gi}_{kind}": _init_stack(generator, cfg, kind, count, dtype,
                                     device)
        for gi, (kind, count) in enumerate(layer_groups(cfg))}
    if cfg.encdec:
        params["encoder"] = _init_stack(generator, cfg, "enc",
                                        cfg.encdec.n_enc_layers, dtype,
                                        device)
        params["enc_norm"] = ninit(cfg.d_model, dtype, device)
    params["final_norm"] = ninit(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = _init(generator, (cfg.d_model, cfg.vocab), dtype,
                                  device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _sinusoid(positions, d: int, dtype):
    """Sinusoidal position embedding (the JAX package's stand-in for
    Whisper's learned table): sin and cos of ``positions`` (any shape)
    times ``d / 2`` geometric frequencies from 1 to 1/10000."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                     / max(half - 1, 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def token_embeds(tokens, d_model: int, dtype=torch.float32):
    """Tokens as a model with embedding inputs takes them:
    one_hot(token % d_model) * 0.02, the JAX trainer's map
    (``repro/launch/train.py:make_batch``)."""
    return F.one_hot(tokens.long() % d_model, d_model).to(dtype) * 0.02


def _embed_inputs(params, batch, cfg: ModelConfig, pos: int | None = None):
    """The decoder's input (B, S, d): ``batch["embeds"]`` for embedding
    inputs, else the embedded tokens, plus the sinusoid at positions 0..S-1
    (or at ``pos``, a decode step's) for the audio family."""
    if cfg.input_kind == "embeds":
        return batch["embeds"]
    tokens = batch["tokens"]
    x = F.embedding(tokens, gather_weights(params["embed"]))
    if cfg.family == "audio":
        b, s = tokens.shape
        p = (torch.arange(s, device=x.device) if pos is None
             else torch.full((s,), pos, device=x.device))
        x = x + _sinusoid(p[None].expand(b, s), cfg.d_model, x.dtype)
    return x


def _remat_contexts():
    """``checkpoint``'s ``context_fn``: nothing around the forward, the
    ``model.remat_recompute`` span around the block's re-run in the
    backward."""
    return nullcontext(), span(REMAT)


def run_encoder(params, batch, cfg: ModelConfig, remat: bool = False):
    """The audio encoder (``repro/models/model.py:_run_encoder``) over
    ``batch["audio_embeds"]`` (B, frames, d): the sinusoid added, the
    ``"enc"`` blocks, then ``enc_norm``."""
    h = batch["audio_embeds"]
    b, f = h.shape[:2]
    h = h + _sinusoid(torch.arange(f, device=h.device)[None].expand(b, f),
                      cfg.d_model, h.dtype)

    def enc(x, lp):
        return apply_block(lp, x, cfg, "enc", {})[0]

    for lp in _layers(params["encoder"]):
        h = (checkpoint(enc, h, lp, use_reentrant=False,
                        preserve_rng_state=False, context_fn=_remat_contexts)
             if remat else enc(h, lp))
    return _norm_apply(cfg)(params["enc_norm"], h, cfg.norm_eps)


def _head(params, x, cfg: ModelConfig):
    x = _norm_apply(cfg)(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x @ gather_weights(head)


def forward(params, batch, cfg: ModelConfig, remat: bool = False,
            last_only: bool = False):
    """Full-sequence forward -> (logits, aux_loss).  ``remat`` keeps only
    each block's input for the backward and runs the block again there
    (``torch.utils.checkpoint``, non-reentrant, the re-run in a
    ``model.remat_recompute`` span), as the JAX package wraps each scanned
    block in ``jax.checkpoint``; the kernels then run once in the forward
    and once in the recompute.  ``last_only`` computes the LM
    head on the final position only (prefill serving).  ``aux_loss`` is
    the MoE blocks' load-balance losses summed (fp32), zero without MoE.
    The batch holds ``tokens``, or ``embeds`` and ``positions3`` (M-RoPE),
    and ``audio_embeds`` for an encoder-decoder."""
    x = hint(_embed_inputs(params, batch, cfg), batch_axes())
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    ctx = {"positions": positions, "positions3": batch.get("positions3"),
           "causal": True}
    if cfg.encdec:
        ctx["enc_out"] = run_encoder(params, batch, cfg, remat=remat)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for gname, gparams in params["groups"].items():
        kind = gname.split("_", 1)[1]

        def blk(x, lp, kind=kind):
            y, _, aux = apply_block(lp, x, cfg, kind, ctx)
            return y, aux

        auxs = []
        for lp in _layers(gparams):
            if remat:
                x, aux = checkpoint(blk, x, lp, use_reentrant=False,
                                    preserve_rng_state=False,
                                    context_fn=_remat_contexts)
            else:
                x, aux = blk(x, lp)
            if aux is not None:
                auxs.append(aux)
        if auxs:
            aux_total = aux_total + torch.stack(auxs).sum()
    if last_only:
        x = x[:, -1:, :]
    logits = hint(_head(params, x, cfg), batch_axes(), None, "model")
    return logits, aux_total


def _sharded_lse_and_pick(logits32, labels):
    """logsumexp over the vocabulary and the labels' logits, on the dry
    run's DTensors with the vocabulary over ``model`` (as GSPMD partitions
    them): each device reduces its slice of the vocabulary, then one max
    and two sums go over ``model``.  DTensor would gather the vocabulary."""
    from torch.distributed import _functional_collectives as funcol
    dm = logits32.device_mesh
    names = tuple(dm.mesh_dim_names)
    vocab = logits32.shape[-1]
    split = "model" in names and vocab % dm.shape[names.index("model")] == 0
    mi = names.index("model") if split else None
    bd = batch_axes()

    def local(lg, lab):
        if mi is None:
            return (torch.logsumexp(lg, dim=-1),
                    torch.gather(lg, -1, lab[..., None])[..., 0])
        v_loc = lg.shape[-1]
        lo = dm.get_local_rank("model") * v_loc
        mx = funcol.all_reduce(lg.detach().amax(-1), "max", (dm, mi))
        se = funcol.all_reduce(torch.exp(lg - mx[..., None]).sum(-1), "sum",
                               (dm, mi))
        rel = lab - lo
        mine = (rel >= 0) & (rel < v_loc)
        pk = torch.gather(lg, -1, torch.clamp(rel, 0, v_loc - 1)[..., None])
        pk = funcol.all_reduce(torch.where(mine, pk[..., 0], 0.0), "sum",
                               (dm, mi))
        return mx + torch.log(se), pk

    return shardwise(local, (logits32, labels),
                     ((bd, None, "model" if split else None), (bd, None)),
                     (labels.shape, labels.shape), ((bd,), (bd,)))


def loss_fn(params, batch, cfg: ModelConfig, remat: bool = False):
    """Mean next-token cross-entropy over ``loss_mask`` (all ones when the
    batch has none) plus the aux loss -> (loss, {"nll", "aux"}).  As in the
    JAX package, the log-softmax is never formed: fp32 logsumexp minus the
    picked logit, and the mask's sum is kept at least 1."""
    logits, aux = forward(params, batch, cfg, remat=remat)
    labels = batch["labels"].long()
    logits32 = hint(logits.float(), batch_axes(), None, "model")
    if is_dtensor(logits32):
        lse, picked = _sharded_lse_and_pick(logits32, labels)
    else:
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
    if cfg.mla:
        m = cfg.mla
        return {"c_kv": zeros(batch, max_len, m.kv_lora),
                "k_rope": zeros(batch, max_len, m.qk_rope_dim), "idx": 0}
    kv = {"k": zeros(batch, max_len, cfg.n_kv_heads, cfg.hd),
          "v": zeros(batch, max_len, cfg.n_kv_heads, cfg.hd),
          "idx": 0}
    return {"self": kv} if kind == "dec" else kv


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.float32, device=None,
                      enc_out=None) -> dict:
    """Per-group caches stacked on a leading layer axis, and the step
    counter ``pos``.  Dense and MoE: ``{"k", "v": (L, B, max_len, K, hd),
    "idx"}``, or with MLA the latent ``{"c_kv": (L, B, max_len, kv_lora),
    "k_rope": (L, B, max_len, qk_rope), "idx"}``.  Decoder of an
    encoder-decoder: ``{"self": {"k", "v", "idx"}}``, and ``enc_out``
    (B, frames, d), the encoder's output that cross-attention reads, is
    kept in the state.  Mamba: ``{"conv": (L, B, d_conv-1, d_inner+2n)`` in
    ``dtype``, ``"state": (L, B, heads, head_dim, n)`` fp32``}``.  Griffin:
    a list, one entry per sub-block: ``{"conv", "h"}`` (h fp32) for a
    recurrent one, ``{"k", "v": (L, B, min(window, max_len), K, hd),
    "idx"}`` for local attention."""
    device = resolve_device(device)
    caches = {f"g{gi}_{kind}": _empty_cache_block(cfg, kind, count, batch,
                                                  max_len, dtype, device)
              for gi, (kind, count) in enumerate(layer_groups(cfg))}
    state = {"caches": caches, "pos": 0}
    if enc_out is not None:
        state["enc_out"] = enc_out
    return state


def _advance(cache, s: int):
    """The group cache with every ``idx`` moved on by ``s``."""
    if isinstance(cache, list):
        return [_advance(c, s) for c in cache]
    if "idx" in cache:
        return {**cache, "idx": cache["idx"] + s}
    return {k: _advance(v, s) if isinstance(v, (dict, list)) else v
            for k, v in cache.items()}


def decode_step(params, state, batch, cfg: ModelConfig):
    """One-token decode.  batch: {tokens: (B, 1)}, or {embeds: (B, 1, d),
    positions3: (3, B, 1)} for embedding inputs.  Returns (logits
    (B, 1, V), new_state).  The caches of ``state`` are written in place
    and shared with the new state."""
    pos = state["pos"]
    x = _embed_inputs(params, batch, cfg, pos=pos)
    b, s = x.shape[:2]
    ctx = {"positions": torch.full((b, s), pos, device=x.device),
           "positions3": batch.get("positions3"), "causal": True}
    if "enc_out" in state:
        ctx["enc_out"] = state["enc_out"]
    new_caches = {}
    for gname, gparams in params["groups"].items():
        kind = gname.split("_", 1)[1]
        cache = state["caches"][gname]
        for i in range(_count(gparams)):
            x, nc, _ = apply_block(_layer(gparams, i), x, cfg, kind, ctx,
                                   cache=_layer(cache, i))
            _set_layer(cache, i, nc)
        new_caches[gname] = _advance(cache, s)
    return _head(params, x, cfg), {**state, "caches": new_caches,
                                   "pos": pos + 1}
