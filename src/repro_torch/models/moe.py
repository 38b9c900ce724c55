"""Mixture-of-Experts layer (GShard-style capacity dispatch): the PyTorch
counterpart of ``repro/models/moe.py``.

Covers Grok-1 (8 experts, top-2) and DeepSeek-V2 (2 shared + 160 routed,
top-6).  The routed experts' weights are stacked ``(E, d, f)`` and the
shared experts' ``(S, d, f)``, as in the JAX package, so its parameters
convert leaf for leaf.

The JAX package takes its expert-parallel ``apply_moe_ep_shmap`` only
under an active production mesh (``sharding/hints._active_mesh``), which
the port does not have; without one it runs ``_apply_moe_gspmd``, and so
does :func:`apply_moe` here.  Each expert's MLP is one batched product over
the expert axis (``jax.vmap`` of plain matmuls in the JAX package).

:data:`routing_log`, when set to a list, receives each call's routing
``(top_e, keep)`` (both ``(tokens, top_k)``), so that a caller can compare
the routing of two runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _init, apply_mlp, init_mlp

#: a list that each :func:`apply_moe` call appends its (top_e, keep) to,
#: or None
routing_log: list | None = None


def _stacked_mlp(generator, n, d, ff, kind, dtype, device):
    """``n`` MLPs' weights, each leaf stacked on a leading axis of ``n``."""
    one = init_mlp(generator, d, ff, kind, dtype, device)
    out = {k: v.new_empty((n,) + v.shape) for k, v in one.items()}
    for i in range(n):
        if i:
            one = init_mlp(generator, d, ff, kind, dtype, device)
        for k, v in one.items():
            out[k][i] = v
    return out


def init_moe(generator, cfg: ModelConfig, dtype, device):
    m = cfg.moe
    d = cfg.d_model
    p = {"router": _init(generator, (d, m.n_experts), dtype, device),
         "experts": _stacked_mlp(generator, m.n_experts, d, m.d_expert,
                                 cfg.mlp, dtype, device)}
    if m.n_shared:
        p["shared"] = _stacked_mlp(generator, m.n_shared, d, m.d_expert,
                                   cfg.mlp, dtype, device)
    return p


def capacity(tokens: int, m) -> int:
    """Slots per expert: every token under ``exact``; else ``tokens * top_k
    * capacity_factor / n_experts``, at least 1, and rounded up to a
    multiple of 128 above 128 (``repro/models/moe.py:_capacity``)."""
    if m.exact:
        return tokens
    cap = max(int(tokens * m.top_k * m.capacity_factor / m.n_experts), 1)
    return ((cap + 127) // 128) * 128 if cap > 128 else cap


def apply_moe(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux_loss).

    The fp32 softmax router picks each token's ``top_k`` experts (in
    descending order, as ``jax.lax.top_k``) and renormalizes their
    weights.  A stable argsort of the expert ids ranks each assignment
    within its expert, token by token; an assignment ranked at or past the
    capacity is dropped (it writes nothing, JAX's ``mode="drop"``, and its
    weight is 0).  The kept ones go to an ``(E, cap, d)`` buffer, every
    expert's MLP runs as one batched product, and each token gathers and
    weighs its experts' outputs.  Shared experts see every token.  The aux
    loss is Switch's load-balance term."""
    m = cfg.moe
    b, s, d = x.shape
    tokens = b * s
    E, k = m.n_experts, m.top_k
    xt = x.reshape(tokens, d)
    logits = (xt @ p["router"]).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)           # (T, k)
    top_p = top_p / top_p.sum(-1, keepdim=True)

    cap = capacity(tokens, m)
    A = tokens * k
    flat_e = top_e.reshape(A)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(A, device=x.device) - starts[flat_e[order]]
    pos = torch.empty_like(ranks).scatter_(0, order, ranks)
    keep = pos < cap                                       # (A,)
    if routing_log is not None:
        routing_log.append((top_e, keep.reshape(tokens, k)))

    slot = flat_e * cap + torch.clamp(pos, max=cap - 1)    # (A,)
    expert_in = x.new_zeros((E * cap, d))
    expert_in.index_copy_(0, slot[keep],
                          xt.repeat_interleave(k, dim=0)[keep])
    expert_out = apply_mlp(p["experts"], expert_in.reshape(E, cap, d),
                           cfg.mlp)                        # (E, cap, d)
    gathered = expert_out.reshape(E * cap, d)[slot].reshape(tokens, k, d)
    w = (top_p * keep.reshape(tokens, k)).to(x.dtype)
    y = torch.einsum("tkd,tk->td", gathered, w)

    if m.n_shared:
        y = y + apply_mlp(p["shared"], xt[None], cfg.mlp).sum(0)

    me = probs.mean(0)                                     # (E,)
    ce = F.one_hot(top_e, E).sum(1).float().mean(0)
    aux = m.router_aux_coef * E * torch.sum(me * ce)
    return y.reshape(b, s, d).to(x.dtype), aux
