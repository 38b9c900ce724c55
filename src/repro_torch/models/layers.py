"""Neural-net building blocks: the PyTorch counterpart of
``repro/models/layers.py``.

Every block is a pair ``init_*(generator, ...) -> params`` /
``apply_*(params, x, ...) -> y`` over plain dicts of tensors, laid out as in
the JAX package so that its parameters convert leaf for leaf
(:mod:`repro_torch.convert`).  The sharding hint of the JAX package's
decode attention is here (:mod:`repro_torch.sharding.hints`), and a width
split into heads goes through ``hints.split_heads`` first.

Attention runs through :mod:`repro_torch.kernels.ops`, which dispatches
between the Hopper flash-attention kernel and its plain version.  MLA's
prefill reaches the kernel with q and k at head dim 192 and v at 128, a
call the JAX package's Pallas kernel cannot take (it sizes v and the
output by q's head dim); its plain path, which the port follows, gives
the output v's head dim.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.policy import use_kernels
from ..sharding.hints import (batch_axes, hint, is_dtensor, keep_layout,
                              local_call, shardwise, split_heads, unshard)
from .config import ModelConfig

NEG_INF = -1e30


def _init(generator, shape, dtype, device, scale=0.02):
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d, dtype, device):
    return {"w": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p, x, eps=1e-5):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * p["w"]


def init_layernorm(d, dtype, device):
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["w"] + p["b"]


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def _rotate(x, ang):
    """Rotate the two halves of x (B, S, H, hd) by ang (B, S, hd/2)."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (hd/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions3 (3, B, S) = (t, h, w) ids;
    the head dim's frequency bands are cut into ``sections``, and the bands
    of section i turn by position stream i [arXiv:2409.12191]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    sec = torch.cat([torch.full((n,), i, device=x.device)
                     for i, n in enumerate(sections)])[: hd // 2]
    ang = positions3.float()[sec].movedim(0, -1) * freqs   # (B,S,hd/2)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def init_mlp(generator, d, ff, kind, dtype, device):
    p = {}
    if kind in ("swiglu", "geglu"):
        p["gate"] = _init(generator, (d, ff), dtype, device)
    p["up"] = _init(generator, (d, ff), dtype, device)
    p["down"] = _init(generator, (ff, d), dtype, device)
    return p


def apply_mlp(p, x, kind):
    up = x @ p["up"]
    if kind == "swiglu":
        h = F.silu(x @ p["gate"]) * up
    elif kind == "geglu":
        h = F.gelu(x @ p["gate"], approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["down"]


# ---------------------------------------------------------------------------
# attention (GQA, optional sliding window, KV cache)
# ---------------------------------------------------------------------------

def init_attention(generator, cfg: ModelConfig, dtype, device,
                   cross: bool = False):
    """Self-attention, or cross-attention (no biases) with ``cross``."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": _init(generator, (d, H * hd), dtype, device),
         "wk": _init(generator, (d, K * hd), dtype, device),
         "wv": _init(generator, (d, K * hd), dtype, device),
         "wo": _init(generator, (H * hd, d), dtype, device)}
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", H), ("bk", K), ("bv", K)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    return p


def cache_write(buf, new, idx: int):
    """Write ``new`` (B, s, ...) into ``buf`` (B, S, ...) at position
    ``idx`` and return ``buf``.  The port writes the cache in place, where
    the JAX package builds a new buffer; the values are the same.  Under
    the dry run's mesh, where the cache's sequence is over ``model``, each
    device writes the positions it holds."""
    if is_dtensor(buf):
        return _cache_write_sharded(buf, new, idx)
    buf[:, idx:idx + new.shape[1]] = new.to(buf.dtype)
    return buf


def _cache_write_sharded(buf, new, idx: int):
    from torch.distributed.tensor import Replicate
    dm = buf.device_mesh
    seq = [i for i, p in enumerate(buf.placements)
           if p.is_shard() and p.dim == 1]
    new_pl = [Replicate() if i in seq else p
              for i, p in enumerate(buf.placements)]

    def local(bl, nl):
        lo = 0
        for i in seq:    # this device's first position
            lo = lo * dm.shape[i] + dm.get_coordinate()[i]
        lo *= bl.shape[1]
        a, z = max(idx, lo), min(idx + nl.shape[1], lo + bl.shape[1])
        if a < z:
            bl[:, a - lo:z - lo] = nl[:, a - idx:z - idx].to(bl.dtype)
        return bl

    return local_call(local, (buf, new), (list(buf.placements), new_pl),
                      list(buf.placements), dm)


_CHUNK_Q = 1024
_CHUNK_THRESHOLD = 8 * 1024 * 1024  # sq*sk above which q-chunking kicks in


def _sdpa_block(q, k, v, *, causal, window, q_offset, length_mask,
                kv_seq_hint: bool = False):
    """Plain GQA attention.  ``kv_seq_hint`` (decode) groups the queries as
    (b, sq, kv_heads, rep, hd) against the un-repeated cache; otherwise
    (prefill) K/V are repeated over heads, as in the JAX package."""
    b, sq, h, hd = q.shape
    _, sk, kh, _ = k.shape
    rep = h // kh
    if kv_seq_hint:
        # the cache's sequence is over model: the one query's heads whole
        qg = unshard(q, "model").reshape(b, sq, kh, rep, hd)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float()
    else:
        kq = k.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kq).float()
    logits = logits / math.sqrt(hd)
    if kv_seq_hint:
        logits = hint(logits, batch_axes(), None, None, None, "model")
    qi = torch.arange(sq, device=q.device) + q_offset
    ki = torch.arange(sk, device=q.device)
    if causal or window is not None:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= ki[None, :] <= qi[:, None]
        if window is not None:
            mask &= ki[None, :] > qi[:, None] - window
        logits = torch.where(mask, logits, NEG_INF)
    if length_mask is not None:  # (B, Sk) valid-key mask
        lshape = (b,) + (1,) * (logits.dim() - 3) + (1, sk)
        logits = torch.where(length_mask.reshape(lshape), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if kv_seq_hint:
        out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
        return out.reshape(b, sq, h, v.shape[-1])
    vq = v.repeat_interleave(rep, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vq)


def sdpa(q, k, v, *, causal: bool, window: int | None = None,
         q_offset: int = 0, length_mask: torch.Tensor | None = None,
         kv_seq_hint: bool = False):
    """Scaled-dot-product attention with GQA broadcast.

    q: (B, Sq, H, hd); k: (B, Sk, K, hd); v: (B, Sk, K, hd_v), the output
    (B, Sq, H, hd_v) (MLA: hd 192, hd_v 128).  The flash kernel takes the
    call under the JAX package's gate (``layers.py:232-233``: no
    ``q_offset``, no ``length_mask``, ``Sq`` and ``Sk`` multiples of 128,
    ``hd % 8 == 0``) when the policy sends this device to the kernels, or
    raises if the kernel cannot take it (``kernels/policy.py``); every
    call outside the gate takes the plain path.  Long sequences take a
    query-chunked plain path, as in the JAX package.
    """
    b, sq, h, hd = q.shape
    _, sk, kh, _ = k.shape
    if is_dtensor(q) and not kv_seq_hint and length_mask is None:
        return _sdpa_sharded(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if (use_kernels(q.device) and length_mask is None and q_offset == 0
            and sq % 128 == 0 and sk % 128 == 0 and hd % 8 == 0):
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
        return out.transpose(1, 2)
    if sq * sk > _CHUNK_THRESHOLD and sq % _CHUNK_Q == 0 and sq > _CHUNK_Q:
        outs = [
            _sdpa_block(q[:, i:i + _CHUNK_Q], k, v, causal=causal,
                        window=window, q_offset=q_offset + i,
                        length_mask=length_mask, kv_seq_hint=kv_seq_hint)
            for i in range(0, sq, _CHUNK_Q)]
        return torch.cat(outs, dim=1)
    return _sdpa_block(q, k, v, causal=causal, window=window,
                       q_offset=q_offset, length_mask=length_mask,
                       kv_seq_hint=kv_seq_hint)


def _sdpa_sharded(q, k, v, *, causal, window, q_offset):
    """Attention on DTensors (the dry run), by shards: each device runs
    :func:`sdpa` on its batch shard and, where the head count divides the
    ``model`` axis, its query heads, each against the KV heads they read:
    its own KV heads where their count divides ``model`` too, else picked
    from K/V replicated over ``model``.  DTensor cannot propagate the
    (batch x heads) products of the plain version itself."""
    from torch.distributed.tensor import Replicate, Shard
    dm = q.device_mesh
    names = tuple(dm.mesh_dim_names)
    h, kh = q.shape[2], k.shape[2]
    tp = dm.shape[names.index("model")] if "model" in names else 1
    heads = "model" in names and h % tp == 0
    bd = set(batch_axes() or ())

    def placements(shard_heads):   # a mesh dim of one device: replicated
        return tuple(Replicate() if dm.shape[i] == 1
                     else Shard(0) if a in bd and q.shape[0] % dm.shape[i] == 0
                     else Shard(2) if a == "model" and shard_heads
                     else Replicate() for i, a in enumerate(names))

    kv_heads = heads and kh % tp == 0
    qp, kp = placements(heads), placements(kv_heads)
    h0 = dm.get_local_rank("model") * (h // tp) if heads else 0

    def local(ql, kl, vl):
        if kv_heads:      # this device's KV heads are the ones it reads
            return sdpa(ql, kl, vl, causal=causal, window=window,
                        q_offset=q_offset)
        idx = (h0 + torch.arange(ql.shape[2], device=ql.device)) \
            // (h // kh)
        return sdpa(ql, kl.index_select(2, idx), vl.index_select(2, idx),
                    causal=causal, window=window, q_offset=q_offset)

    return local_call(local, (q, k, v), (list(qp), list(kp), list(kp)),
                      list(qp), dm)


def apply_attention(p, x, cfg: ModelConfig, *, positions=None,
                    positions3=None, causal=True, window: int | None = None,
                    cache=None, kv_src=None, use_rope: bool = True):
    """Self-attention, with an optional sliding ``window``, or
    cross-attention to ``kv_src`` (B, S_src, d) (no RoPE, no cache).
    RoPE turns q and k by ``positions3`` (3, B, S) where the config has
    M-RoPE and they are given, else by ``positions``.  ``cache`` (decode):
    dict with k/v (B, S_cache, K, hd) and ``idx`` (an int); returns
    (y, new_cache).

    Decode has the JAX package's two branches (``layers.py:285-302``).  With
    a window and a cache no longer than it, the cache is a ring buffer: the
    token at ``idx`` goes to slot ``idx % S_cache``, and every live slot is
    in the window by construction (keys keep their write-time RoPE).
    Otherwise the cache is written at ``idx`` and the window masks it, with
    the query at offset ``idx``."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, s = x.shape[:2]
    src = x if kv_src is None else kv_src
    q = x @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_heads(q, H).reshape(b, s, H, hd)
    k = split_heads(k, K).reshape(b, src.shape[1], K, hd)
    v = split_heads(v, K).reshape(b, src.shape[1], K, hd)
    if use_rope and kv_src is None:
        if cfg.mrope and positions3 is not None:
            q = apply_mrope(q, positions3, cfg.rope_theta)
            k = apply_mrope(k, positions3, cfg.rope_theta)
        elif positions is not None:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        idx = cache["idx"]
        cache_len = cache["k"].shape[1]
        ring = window is not None and cache_len <= window
        at = idx % cache_len if ring else idx
        ck = cache_write(cache["k"], k, at)
        cv = cache_write(cache["v"], v, at)
        valid = torch.arange(cache_len, device=x.device) < idx + s
        y = sdpa(q, ck, cv, causal=False, window=None if ring else window,
                 q_offset=0 if ring else idx, kv_seq_hint=True,
                 length_mask=valid[None, :].expand(b, cache_len))
        new_cache = {"k": ck, "v": cv, "idx": idx + s}
    else:
        y = sdpa(q, k, v, causal=causal, window=window)
    out = keep_layout(y.reshape(b, s, H * hd)) @ p["wo"]
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2 [arXiv:2405.04434])
# ---------------------------------------------------------------------------

def init_mla(generator, cfg: ModelConfig, dtype, device):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    p = {}
    if m.q_lora:
        p["wq_a"] = _init(generator, (d, m.q_lora), dtype, device)
        p["wq_b"] = _init(generator, (m.q_lora, H * qd), dtype, device)
    else:
        p["wq"] = _init(generator, (d, H * qd), dtype, device)
    # the joint KV low-rank compression and the decoupled rope key
    p["wkv_a"] = _init(generator, (d, m.kv_lora + m.qk_rope_dim), dtype,
                       device)
    p["wkv_b"] = _init(generator,
                       (m.kv_lora, H * (m.qk_nope_dim + m.v_head_dim)),
                       dtype, device)
    p["wo"] = _init(generator, (H * m.v_head_dim, d), dtype, device)
    return p


def apply_mla(p, x, cfg: ModelConfig, *, positions=None, causal=True,
              cache=None):
    """MLA attention -> (y, new_cache).  q and k have head dim
    ``qk_nope + qk_rope`` (the rope key is one head, broadcast over all),
    v has ``v_head_dim``.  The decode cache holds only the compressed
    latent ``c_kv`` (B, S_cache, kv_lora) and the rope key ``k_rope``
    (B, S_cache, qk_rope), written in place at ``idx``; ``wkv_b``
    re-expands the whole cache each step, as in the JAX package."""
    m = cfg.mla
    H = cfg.n_heads
    b, s, _ = x.shape
    qd = m.qk_nope_dim + m.qk_rope_dim
    # the low-rank query whole over model (the identity without a DTensor
    # mesh): wq_b's columns are over model, its rows cannot be as well
    q = hint(x @ p["wq_a"], batch_axes(), None, None) @ p["wq_b"] \
        if m.q_lora else x @ p["wq"]
    q_nope, q_rope = split_heads(q, H).reshape(b, s, H, qd).split(
        [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    if positions is not None:
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv, k_rope = (x @ p["wkv_a"]).split([m.kv_lora, m.qk_rope_dim],
                                          dim=-1)
    k_rope = k_rope[:, :, None, :]                         # (b,s,1,rope)
    if positions is not None:
        k_rope = apply_rope(k_rope, positions, cfg.rope_theta)

    new_cache, valid, q_offset = None, None, 0
    if cache is not None:
        idx = cache["idx"]
        c_kv = cache_write(cache["c_kv"], c_kv, idx)
        r_all = cache_write(cache["k_rope"], k_rope[:, :, 0, :], idx)
        new_cache = {"c_kv": c_kv, "k_rope": r_all, "idx": idx + s}
        valid = torch.arange(c_kv.shape[1], device=x.device) < idx + s
        k_rope, q_offset = r_all[:, :, None, :], idx

    sk = c_kv.shape[1]
    if cache is None:
        kv = split_heads(c_kv @ p["wkv_b"], H)
    else:
        # the cache's sequence is over model under the dry run's mesh:
        # each device expands its own positions with the whole wkv_b
        bd = batch_axes()
        kv = shardwise(torch.matmul, (c_kv, unshard(p["wkv_b"], "model")),
                       ((bd, "model"), ()),
                       ((b, sk, p["wkv_b"].shape[1]),), ((bd, "model"),))
    k_nope, v = kv.reshape(
        b, sk, H, m.qk_nope_dim + m.v_head_dim).split(
        [m.qk_nope_dim, m.v_head_dim], dim=-1)
    # the rope key broadcast over the heads, laid out as k_nope's heads
    k_rope = hint(k_rope.expand(b, sk, H, m.qk_rope_dim), batch_axes(),
                  None, "model", None)
    k = torch.cat([k_nope, k_rope], dim=-1)
    qh = torch.cat([q_nope, q_rope], dim=-1)
    y = sdpa(qh, k, v, causal=causal and cache is None, q_offset=q_offset,
             kv_seq_hint=cache is not None,
             length_mask=None if valid is None
             else valid[None, :].expand(b, sk))
    out = keep_layout(y.reshape(b, s, H * m.v_head_dim)) @ p["wo"]
    return out, new_cache
