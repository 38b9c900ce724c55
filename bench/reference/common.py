"""Pieces the reference models share, and the reference's training steps.

Plain PyTorch, fp32, no kernels and no caches.  The trainer follows the
production recipe the configuration states: each step's rows cut into
consecutive microbatches, the gradients of their losses added up and
divided by their count, then AdamW with global-norm clipping, a linear
warm-up and weight decay on every leaf.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def tree_paths(tree, prefix=()):
    """(path, leaf) of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def path_name(path) -> str:
    return "/".join(path)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """Rotary embedding of x (b, s, h, d) at integer positions (b, s): the
    two halves of the head dim turned by positions * theta^(-2i/d)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    ang = positions.float()[..., None] * inv
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v):
    """softmax(q k^T / sqrt(d), causal) v over q (b, s, h, d), k (b, s,
    kh, d), v (b, s, kh, dv), each key head shared by h / kh query heads
    -> (b, s, h, dv)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    probs = scores.masked_fill(future, float("-inf")).softmax(-1)
    return torch.matmul(probs, v).transpose(1, 2)


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def masked_nll(logits, labels, mask):
    """Mean next-token cross-entropy over the positions ``mask`` keeps."""
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def layer(tree, i):
    """Layer ``i`` of a tree whose leaves are stacked on a layer axis."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def run_block(fn, x, params, remat):
    """``fn(x, params)``, recomputed in the backward when ``remat``."""
    if not remat:
        return fn(x, params)
    names = [p for p, _ in tree_paths(params)]
    leaves = [t for _, t in tree_paths(params)]

    def flat(x, *ts):
        tree: dict = {}
        for path, t in zip(names, ts):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t
        return fn(x, tree)

    return checkpoint(flat, x, *leaves, use_reentrant=False)


def split_rows(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches of consecutive rows."""
    parts = {k: torch.chunk(v, n) for k, v in batch.items()}
    return [{k: parts[k][j] for k in batch} for j in range(n)]


def train(loss_fn, params: dict, batches, microbatches: int, opt: dict,
          loss_scale: float = 1.0, update: bool = True):
    """Run one training step a batch on ``params`` (updated in place) ->
    (each step's loss, the norm of each leaf's step-1 gradient as AdamW
    takes it: clipped).  ``loss_scale`` and ``update`` plant faults: an
    altered loss, a step that leaves the state unchanged."""
    leaves = [(path_name(p), t) for p, t in tree_paths(params)]
    for _, t in leaves:
        t.requires_grad_(True)
    m = [torch.zeros_like(t) for _, t in leaves]
    v = [torch.zeros_like(t) for _, t in leaves]
    losses, first = [], None
    for step, batch in enumerate(batches, 1):
        n = microbatches
        mb_losses = []
        for mb in split_rows(batch, n):
            loss = loss_fn(params, mb) * loss_scale
            loss.backward()
            mb_losses.append(loss.detach())
        losses.append(float(torch.stack(mb_losses).mean()))
        with torch.no_grad():
            grads = [t.grad.div_(n) for _, t in leaves]
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
            for g in grads:
                g.mul_(scale)
            if first is None:
                first = {name: float(torch.linalg.vector_norm(g))
                         for (name, _), g in zip(leaves, grads)}
            if update:
                lr = opt["lr"] * min(step / max(opt["warmup_steps"], 1),
                                     1.0)
                bc1 = 1 - opt["b1"] ** step
                bc2 = 1 - opt["b2"] ** step
                for (_, p), g, mi, vi in zip(leaves, grads, m, v):
                    mi.mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                    vi.mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                    upd = (mi / bc1) / (torch.sqrt(vi / bc2) + opt["eps"])
                    p.sub_(lr * (upd + opt["weight_decay"] * p))
        for _, t in leaves:
            t.grad = None
    for _, t in leaves:
        t.requires_grad_(False)
    return losses, first
