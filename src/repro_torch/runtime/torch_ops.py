"""Local shard semantics of the graph IR's compute ops, on torch tensors.

The port of ``core/op_semantics.py``'s ``local_apply`` and
``stacked_apply``, kind for kind, forward and backward: the same
arithmetic in the same order on torch tensors, so that the
``TorchExecutor`` (``runtime.program``) and the numpy
``SimulatorExecutor`` agree bit for bit wherever the arithmetic is exact
(integer-valued float32 through dot, add, relu, sums and every comm) and
to float tolerance through the transcendental kinds (gelu, silu, softmax,
norms, attention and their grads).  ``op_semantics`` cannot take ``torch``
as its array namespace: it calls ``.astype``, ``xp.take``,
``xp.repeat(..., axis=)``, ``xp.transpose(x, perm)`` and ``np.add.at``.

The output dtype stays ``op_semantics.result_dtype``: the executor casts
each result to it.  Operands of mixed dtypes are first promoted as numpy
promotes them (int32 with float32 gives float64 in numpy, float32 in
torch), except the integer index operands of the four indexing kinds.

``embed_grad`` is numpy's ``np.add.at``: rows are added in the order of
their indices, one pass per occurrence rank, so every device sums its
duplicates in the same order as the simulator, on the CPU and on the GPU
alike (``index_add_`` alone sums duplicates in no fixed order on the GPU).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.op_semantics import (GELU_C, _STACK_BATCHFOLD,
                                           _STACK_TRANSPARENT)

_TORCH_OF = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64,
             np.dtype(np.int32): torch.int32,
             np.dtype(np.int64): torch.int64}
_NUMPY_OF = {v: k for k, v in _TORCH_OF.items()}

#: kinds whose integer operands are indices, not values to promote
_INDEX_KINDS = frozenset(("embedding", "embed_grad", "gather",
                          "gather_grad"))


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return _TORCH_OF[np.dtype(dt)]


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return _NUMPY_OF[dt]


def _promote(kind: str, ins):
    """Cast mixed-dtype operands to numpy's promoted type."""
    if kind in _INDEX_KINDS or len({x.dtype for x in ins}) < 2:
        return ins
    dt = torch_dtype(np.result_type(*(numpy_dtype(x.dtype) for x in ins)))
    return [x.to(dt) for x in ins]


def _f32(x):
    return x.to(torch.float32)


def _scalar32(v) -> float:
    """``v`` rounded to float32, as numpy's ``np.float32(v)`` operand."""
    return float(np.float32(v))


def _mean(x):
    """numpy's mean over the last axis: a sum, then one division."""
    return x.sum(dim=-1, keepdim=True) / x.shape[-1]


def _softmax_lastdim(x):
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=-1, keepdim=True)


def _norm_stats(x, attrs):
    """(normalized x̂ in float32, rsqrt factor r); ``op_semantics``'s."""
    xf = _f32(x)
    eps = _scalar32(attrs.get("eps", 1e-5))
    if attrs.get("norm", "rms") == "layer":
        mu = _mean(xf)
        xc = xf - mu
        var = _mean(xc * xc)
        r = 1.0 / torch.sqrt(var + eps)
        return xc * r, r
    ms = _mean(xf * xf)
    r = 1.0 / torch.sqrt(ms + eps)
    return xf * r, r


def _attn_probs(q, k, attrs):
    """(probs float32, repeated K) of the attention composite."""
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    rep = q.shape[1] // k.shape[1]
    kq = torch.repeat_interleave(k, rep, dim=1)
    logits = _f32(torch.einsum("bhqd,bhkd->bhqk", q, kq))
    logits = logits / _scalar32(np.sqrt(np.float32(d)))
    if attrs.get("causal", True):
        qi = torch.arange(sq, device=q.device)
        ki = torch.arange(sk, device=q.device)
        mask = ki[None, :] <= qi[:, None]
        # a Python scalar, not a tensor made from one: that would be a
        # host-to-device copy, which waits for the stream on the card
        logits = torch.where(mask[None, None], logits, -1e30)
    return _softmax_lastdim(logits), kq


def _fold_gqa(dkq, kh: int):
    """Sum a per-query-head (b, H, sk, d) gradient onto the kv heads."""
    b, h, sk, d = dkq.shape
    return dkq.reshape(b, kh, h // kh, sk, d).sum(dim=2)


def add_rows_in_order(buf, idx, rows):
    """``buf[idx[j]] += rows[j]`` for every ``j`` in index order, as
    ``np.add.at`` adds them: duplicates of one index are summed first
    occurrence first.  One ``index_add_`` per occurrence rank (each holds
    distinct indices, so no pass races with itself)."""
    n = idx.numel()
    if n == 0:
        return buf
    srt, perm = torch.sort(idx, stable=True)
    pos = torch.arange(n, device=idx.device)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = srt[1:] != srt[:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[perm] = pos - run_start
    for r in range(int(rank.max()) + 1):
        sel = torch.nonzero(rank == r).squeeze(1)
        buf.index_add_(0, idx[sel], rows[sel])
    return buf


def local_apply(kind: str, ins, attrs, out_shape, device=None):
    """Apply compute op ``kind`` to device-local input shards (torch
    tensors).  ``out_shape`` is the device-local output shape;
    ``device`` places the outputs of input-less kinds (``ones``)."""
    ins = _promote(kind, list(ins))
    if kind == "gelu":
        x = ins[0]
        return 0.5 * x * (1.0 + torch.tanh(
            GELU_C * (x + 0.044715 * x * x * x)))
    if kind == "relu":
        return torch.clamp_min(ins[0], 0)
    if kind == "scale":
        return ins[0] * attrs.get("factor", 1.0)
    if kind == "add":
        return ins[0] + ins[1]
    if kind == "mul":
        return ins[0] * ins[1]
    if kind == "dot":
        return torch.matmul(ins[0], ins[1])
    if kind == "sum":
        return torch.sum(ins[0], dim=attrs["dim"])
    if kind == "transpose":
        return ins[0].permute(tuple(attrs["perm"]))
    if kind == "reshape":
        return ins[0].reshape(tuple(out_shape))
    if kind == "embedding":
        table, ids = ins
        return table[ids.long()]
    if kind == "silu":
        x = ins[0]
        return x / (1.0 + torch.exp(-x))
    if kind == "rsqrt":
        return 1.0 / torch.sqrt(ins[0])
    if kind == "div":
        return ins[0] / ins[1]
    if kind == "softmax":
        return _softmax_lastdim(ins[0])
    if kind in ("rmsnorm", "layernorm"):
        x, w = ins[0], ins[1]
        xhat, _ = _norm_stats(x, attrs)
        y = xhat.to(x.dtype) * w
        if kind == "layernorm":
            y = y + ins[2]
        return y
    if kind == "gather":          # pick one element along the last axis
        x, ids = ins
        return torch.gather(x, -1, ids.long()[..., None])[..., 0]
    if kind == "attention":       # q (B,H,Sq,D); k/v (B,K,Sk,D), GQA
        q, k, v = ins
        probs, _ = _attn_probs(q, k, attrs)
        vq = torch.repeat_interleave(v, q.shape[1] // k.shape[1], dim=1)
        return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), vq)
    # -- backward-only kernels (reverse-mode autodiff) ----------------------
    if kind == "ones":            # gradient seed dL/dL == 1
        return torch.ones(tuple(out_shape), device=device)
    if kind == "relu_grad":
        dy, x = ins
        return dy * (x > 0)
    if kind == "gelu_grad":
        dy, x = ins
        u = GELU_C * (x + 0.044715 * x * x * x)
        t = torch.tanh(u)
        du = GELU_C * (1.0 + 3 * 0.044715 * x * x)
        return dy * (0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du)
    if kind == "mul_grad":        # dy * other; linear in dy (Partial-safe)
        return ins[0] * ins[1]
    if kind == "bcast":           # VJP of sum: replicate along the new dim
        return ins[0].unsqueeze(attrs["dim"]).expand(tuple(out_shape))
    if kind == "embed_grad":      # VJP of embedding: scatter-add rows
        dy, ids = ins
        d = dy.shape[-1]
        buf = torch.zeros(tuple(out_shape), dtype=dy.dtype, device=dy.device)
        return add_rows_in_order(buf, ids.reshape(-1).long(),
                                 dy.reshape(-1, d))
    if kind == "silu_grad":
        dy, x = ins
        s = 1.0 / (1.0 + torch.exp(-x))
        return dy * (s * (1.0 + x * (1.0 - s)))
    if kind == "softmax_grad":    # dx = y * (dy - <dy, y>); linear in dy
        dy, y = ins
        return y * (dy - torch.sum(dy * y, dim=-1, keepdim=True))
    if kind == "norm_grad_x":     # VJP of rmsnorm/layernorm wrt x
        dy, x, w = ins
        return _norm_grad_x(dy, x, w, attrs)
    if kind == "norm_grad_w":     # dw = sum_lead(dy * x̂); linear in dy
        dy, x = ins
        xhat, _ = _norm_stats(x, attrs)
        t = _f32(dy) * xhat
        return torch.sum(t.reshape(-1, t.shape[-1]), dim=0)
    if kind == "norm_grad_b":     # db = sum_lead(dy)
        dy = ins[0]
        return torch.sum(dy.reshape(-1, dy.shape[-1]), dim=0)
    if kind == "gather_grad":     # one-hot scatter along the last axis
        dy, ids = ins
        onehot = torch.arange(out_shape[-1], device=dy.device) == \
            ids[..., None]
        return onehot.to(dy.dtype) * dy[..., None]
    if kind in ("attn_grad_q", "attn_grad_k", "attn_grad_v"):
        dy, q, k, v = ins
        probs, kq = _attn_probs(q, k, attrs)
        kh = k.shape[1]
        rep = q.shape[1] // kh
        dyf = _f32(dy)
        if kind == "attn_grad_v":
            dvq = torch.einsum("bhqk,bhqd->bhkd", probs, dyf)
            return _fold_gqa(dvq, kh)
        vq = _f32(torch.repeat_interleave(v, rep, dim=1))
        dp = torch.einsum("bhqd,bhkd->bhqk", dyf, vq)
        ds = probs * (dp - torch.sum(dp * probs, dim=-1, keepdim=True))
        scale = _scalar32(np.float32(1.0)
                          / np.float32(np.sqrt(np.float32(q.shape[-1]))))
        if kind == "attn_grad_q":
            return torch.einsum("bhqk,bhkd->bhqd", ds, _f32(kq)) * scale
        dkq = torch.einsum("bhqk,bhqd->bhkd", ds, _f32(q)) * scale
        return _fold_gqa(dkq, kh)
    raise NotImplementedError(f"no local semantics for op kind {kind!r}")


def _norm_grad_x(dy, x, w, attrs):
    xhat, r = _norm_stats(x, attrs)
    dxhat = _f32(dy * w)
    d = float(x.shape[-1])
    if attrs.get("norm", "rms") == "layer":
        return r * (dxhat - _mean(dxhat) - xhat * _mean(dxhat * xhat))
    return r * dxhat - (xhat * r) * torch.sum(
        dxhat * xhat, dim=-1, keepdim=True) / d


def stacked_apply(kind: str, ins, attrs, out_shape, n: int, device=None):
    """Apply ``kind`` to ``n`` same-shaped device shards at once: every
    input is the class-stacked ``(n, *local)`` tensor, ``out_shape`` the
    per-device local output shape.  Returns ``(n, *out_shape)``, or
    ``None`` where the kind has no stacked form (the caller then loops
    over the rows).  Row ``j`` equals ``local_apply`` on row ``j`` of each
    input: the adapters only re-index axes, as ``op_semantics``'s do."""
    ins = _promote(kind, list(ins))
    if kind in _STACK_TRANSPARENT:
        return local_apply(kind, ins, attrs, out_shape, device)
    if kind in _STACK_BATCHFOLD:
        b = ins[0].shape[1]
        folded = [x.reshape((-1,) + tuple(x.shape[2:])) for x in ins]
        y = local_apply(kind, folded, attrs, None, device)
        return y.reshape((n, b) + tuple(y.shape[1:]))
    if kind == "dot":
        a, b = ins
        if a.dim() < 3 or b.dim() < 3:
            return None           # 1-D operand: matmul semantics differ
        if a.dim() > b.dim():
            b = b.reshape((n,) + (1,) * (a.dim() - b.dim())
                          + tuple(b.shape[1:]))
        elif b.dim() > a.dim():
            a = a.reshape((n,) + (1,) * (b.dim() - a.dim())
                          + tuple(a.shape[1:]))
        return torch.matmul(a, b)
    if kind == "sum":
        d = attrs["dim"]
        return torch.sum(ins[0], dim=(d + 1 if d >= 0 else d))
    if kind == "transpose":
        return ins[0].permute((0,) + tuple(p + 1 for p in attrs["perm"]))
    if kind == "reshape":
        return ins[0].reshape((n,) + tuple(out_shape))
    if kind == "bcast":
        d = attrs["dim"]
        return ins[0].unsqueeze(d + 1 if d >= 0 else d).expand(
            (n,) + tuple(out_shape))
    if kind == "ones":
        return torch.ones((n,) + tuple(out_shape), device=device)
    if kind == "embedding":
        table, ids = ins
        rows = torch.arange(n, device=table.device)[:, None]
        picked = table[rows, ids.reshape(n, -1).long()]
        return picked.reshape((n,) + tuple(out_shape))
    if kind == "embed_grad":
        dy, ids = ins
        d = dy.shape[-1]
        vocab = out_shape[0]
        buf = torch.zeros((n * vocab,) + tuple(out_shape[1:]),
                          dtype=dy.dtype, device=dy.device)
        base = torch.arange(n, device=dy.device)[:, None] * vocab
        idx = (ids.reshape(n, -1).long() + base).reshape(-1)
        add_rows_in_order(buf, idx, dy.reshape(-1, d))
        return buf.reshape((n,) + tuple(out_shape))
    if kind in ("rmsnorm", "layernorm"):
        x, w = ins[0], ins[1]
        wr = w.reshape((n,) + (1,) * (x.dim() - 2) + tuple(w.shape[1:]))
        xhat, _ = _norm_stats(x, attrs)
        y = xhat.to(x.dtype) * wr
        if kind == "layernorm":
            y = y + ins[2].reshape(
                (n,) + (1,) * (x.dim() - 2) + tuple(w.shape[1:]))
        return y
    if kind == "norm_grad_x":
        dy, x, w = ins
        wr = w.reshape((n,) + (1,) * (x.dim() - 2) + tuple(w.shape[1:]))
        return _norm_grad_x(dy, x, wr, attrs)
    if kind == "norm_grad_w":
        dy, x = ins
        xhat, _ = _norm_stats(x, attrs)
        t = _f32(dy) * xhat
        return torch.sum(t.reshape(n, -1, t.shape[-1]), dim=1)
    if kind == "norm_grad_b":
        dy = ins[0]
        return torch.sum(dy.reshape(n, -1, dy.shape[-1]), dim=1)
    return None
