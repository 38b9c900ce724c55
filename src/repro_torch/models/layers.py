"""Neural-net building blocks: the PyTorch counterpart of
``repro/models/layers.py``.

Every block is a pair ``init_*(generator, ...) -> params`` /
``apply_*(params, x, ...) -> y`` over plain dicts of tensors, laid out as in
the JAX package so that its parameters convert leaf for leaf
(:mod:`repro_torch.convert`).  The JAX package's sharding hints
(``repro.sharding.hints``: ``hint``, ``batch_axes``) are identities
without a mesh; the port has no mesh and drops them.

Attention runs through :mod:`repro_torch.kernels.ops`, which dispatches
between the Hopper flash-attention kernel and its plain version.
M-RoPE and MLA come with the slices that port their model families.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.policy import use_kernels
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


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (hd/2,)
    ang = positions[..., None].float() * freqs              # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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

def init_attention(generator, cfg: ModelConfig, dtype, device):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": _init(generator, (d, H * hd), dtype, device),
         "wk": _init(generator, (d, K * hd), dtype, device),
         "wv": _init(generator, (d, K * hd), dtype, device),
         "wo": _init(generator, (H * hd, d), dtype, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", H), ("bk", K), ("bv", K)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    return p


def cache_write(buf, new, idx: int):
    """Write ``new`` (B, s, ...) into ``buf`` (B, S, ...) at position
    ``idx`` and return ``buf``.  The port writes the cache in place, where
    the JAX package builds a new buffer; the values are the same."""
    buf[:, idx:idx + new.shape[1]] = new.to(buf.dtype)
    return buf


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
        qg = q.reshape(b, sq, kh, rep, hd)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float()
    else:
        kq = k.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kq).float()
    logits = logits / math.sqrt(hd)
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

    q: (B, Sq, H, hd); k/v: (B, Sk, K, hd).  The flash kernel takes the
    call under the JAX package's gate (``layers.py:232-233``: no
    ``q_offset``, no ``length_mask``, ``Sq`` and ``Sk`` multiples of 128,
    ``hd % 8 == 0``) when the policy sends this device to the kernels, or
    raises if the kernel cannot take it (``kernels/policy.py``); every
    call outside the gate takes the plain path.  Long sequences take a
    query-chunked plain path, as in the JAX package.
    """
    b, sq, h, hd = q.shape
    _, sk, kh, _ = k.shape
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


def apply_attention(p, x, cfg: ModelConfig, *, positions=None, causal=True,
                    window: int | None = None, cache=None):
    """Self-attention, with an optional sliding ``window``.  ``cache``
    (decode): dict with k/v (B, S_cache, K, hd) and ``idx`` (an int);
    returns (y, new_cache).

    Decode has the JAX package's two branches (``layers.py:285-302``).  With
    a window and a cache no longer than it, the cache is a ring buffer: the
    token at ``idx`` goes to slot ``idx % S_cache``, and every live slot is
    in the window by construction (keys keep their write-time RoPE).
    Otherwise the cache is written at ``idx`` and the window masks it, with
    the query at offset ``idx``."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, s = x.shape[:2]
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, H, hd)
    k = k.reshape(b, s, K, hd)
    v = v.reshape(b, s, K, hd)
    if positions is not None:
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
    out = y.reshape(b, s, H * hd) @ p["wo"]
    return out, new_cache
