"""Mixture-of-Experts layer (GShard-style capacity dispatch): the PyTorch
counterpart of ``repro/models/moe.py``.

Covers Grok-1 (8 experts, top-2) and DeepSeek-V2 (2 shared + 160 routed,
top-6).  The routed experts' weights are stacked ``(E, d, f)`` and the
shared experts' ``(S, d, f)``, as in the JAX package, so its parameters
convert leaf for leaf.

:func:`apply_moe` takes the expert-parallel :func:`apply_moe_ep` (the
JAX package's ``apply_moe_ep_shmap``) under the JAX package's gate: an
active mesh (:func:`repro_torch.sharding.hints.use_mesh`) with a
``model`` axis that divides the expert count, at least 4096 tokens, and
tokens that divide over the batch axes; otherwise the capacity dispatch
``_apply_moe_gspmd`` (on the dry run's DTensors, a stand-in for it:
:func:`dtensor_formulation`).  Each expert's MLP is one batched product
over the expert axis (``jax.vmap`` of plain matmuls in the JAX package).

:data:`routing_log`, when set to a list, receives each call's routing
``(top_e, keep)`` (both ``(tokens, top_k)``), so that a caller can compare
the routing of two runs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..sharding import hints
from .config import ModelConfig
from .layers import _init, apply_mlp, init_mlp

#: the fewest tokens that take the expert-parallel formulation (the JAX
#: package's gate: below it the expert weights' gathers dominate)
EP_MIN_TOKENS = 4096

#: a list that each :func:`apply_moe` call appends its (top_e, keep) to,
#: or None
routing_log: list | None = None


def _stacked_mlp(generator, n, d, ff, kind, dtype, device):
    """``n`` MLPs' weights, each leaf stacked on a leading axis of ``n``."""
    one = init_mlp(generator, d, ff, kind, dtype, device)
    out = {k: v.new_empty((n,) + v.shape) for k, v in one.items()}
    if torch.device(device).type == "meta":
        return out
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


def _route(xt, router, m):
    """The fp32 softmax router: probabilities (T, E), the top-k experts of
    each token in descending order and their renormalized weights."""
    probs = torch.softmax((xt @ router).float(), dim=-1)
    top_p, top_e = torch.topk(probs, m.top_k, dim=-1)
    return probs, top_p / top_p.sum(-1, keepdim=True), top_e


def _aux(probs, top_e, m):
    """Switch's load-balance term."""
    me = probs.mean(0)
    ce = F.one_hot(top_e, m.n_experts).sum(1).float().mean(0)
    return m.router_aux_coef * m.n_experts * torch.sum(me * ce)


def positions(flat, n: int):
    """Each entry of ``flat`` (ids below ``n``) ranked among the entries
    of its id, in order: a stable argsort of the ids, each id's start from
    a scatter-add of ones (the reference's ``.at[flat_e].add(1)``; DTensor
    has no rule for ``bincount``) and a scatter back."""
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n, dtype=flat.dtype, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(flat.numel(), device=flat.device) \
        - starts[flat[order]]
    return torch.empty_like(ranks).scatter_(0, order, ranks)


def ep_local(xt, router, experts, shared, cfg: ModelConfig, lo: int,
             tp: int):
    """One device's share of :func:`apply_moe_ep`: its tokens ``xt``
    (T, d), through the experts ``experts`` holds (``lo`` onwards) with a
    capacity of its own token count, plus the shared experts divided by
    ``tp`` -> (y, aux), y partial over the ``model`` axis.  The reference's
    ``apply_moe_ep_shmap.local`` step for step."""
    m = cfg.moe
    T, d = xt.shape
    k = m.top_k
    e_loc = _first(experts).shape[0]
    probs, top_p, top_e = _route(xt, router, m)
    cap = capacity(T, m)
    rel = top_e - lo                                       # (T, k)
    mine = (rel >= 0) & (rel < e_loc)
    A = T * k
    flat_rel = torch.where(mine, rel, e_loc).reshape(A)
    pos = positions(flat_rel, e_loc + 1)
    keep = mine.reshape(A) & (pos < cap)
    if routing_log is not None:     # keep: of this device's experts only
        routing_log.append((top_e, keep.reshape(T, k)))
    # a dropped assignment adds into one spare row past the buffer (JAX's
    # mode="drop"), so that no shape depends on the routing
    spare = e_loc * cap
    slot = torch.where(keep, flat_rel * cap + torch.clamp(pos, max=cap - 1),
                       spare)
    buf = xt.new_zeros((spare + 1, d))
    buf.index_add_(0, slot, xt.repeat_interleave(k, dim=0))
    out = apply_mlp(experts, buf[:spare].reshape(e_loc, cap, d), cfg.mlp)
    gathered = out.reshape(spare, d)[torch.clamp(slot, max=spare - 1)] \
        .reshape(T, k, d)
    w = (top_p * keep.reshape(T, k)).to(xt.dtype)
    y = torch.einsum("tkd,tk->td", gathered, w)
    if m.n_shared:
        y = y + apply_mlp(shared, xt[None], cfg.mlp).sum(0) / tp
    return y, _aux(probs, top_e, m)


def _first(tree):
    return next(iter(tree.values()))


def _batch_shards(mesh) -> tuple[tuple[str, ...], int]:
    """The batch axes of ``mesh`` and how many shards they make."""
    bd = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return bd, int(np.prod([mesh.shape[a] for a in bd])) if bd else 1


def _ep_shape(mesh, cfg):
    tp = mesh.shape["model"]
    bd, nb = _batch_shards(mesh)
    return tp, bd, nb, cfg.moe.n_experts // tp


def apply_moe_ep(p, x, cfg: ModelConfig):
    """Expert-parallel MoE over the active mesh (the JAX package's
    ``apply_moe_ep_shmap``): each (batch shard x ``model`` shard) device
    routes its batch shard's tokens, sends them through its E/tp experts at
    a capacity per (batch shard x expert), adds the shared experts / tp;
    one sum over ``model`` combines the partial outputs, and the aux loss
    is averaged over ``model`` and the batch axes.  Needs E % tp == 0.

    Three carriers of the same computation:

    * the dry run's DeviceMesh: ``local_map`` over DTensors, experts
      sharded over ``model``, the sum a functional all-reduce,
    * real ranks (``hints.use_mesh(..., ranks=)``): ``x`` is this rank's
      batch shard, ``p["experts"]`` its own E/tp experts (or all E, sliced
      here); partial output and aux go through one all-reduce over the
      ``model`` group, staged through host memory when the ranks share a
      GPU over gloo,
    * neither (one process): every (batch shard, ``model`` shard) in turn,
      the partial outputs added in ``model`` order."""
    act = hints.active()
    mesh = act.mesh
    m = cfg.moe
    b, s, d = x.shape
    tp, bd, nb, e_loc = _ep_shape(mesh, cfg)
    shared = p.get("shared")
    if act.device_mesh is not None:
        return _ep_dtensor(p, x, cfg, act.device_mesh)
    if act.ranks is not None:
        coords = mesh.coords(act.ranks.rank)
        lo = coords["model"] * e_loc
        experts = p["experts"]
        if _first(experts).shape[0] == m.n_experts:
            experts = {k: v[lo:lo + e_loc] for k, v in experts.items()}
        y, aux = ep_local(x.reshape(b * s, d), p["router"], experts, shared,
                          cfg, lo, tp)
        y, aux = _rank_reduce(act, y, aux, tp, bd)
        return y.reshape(b, s, d).to(x.dtype), aux
    xt = x.reshape(b * s, d)
    t_loc = xt.shape[0] // nb
    ys, auxs = [], []
    for i in range(nb):
        y_i, aux_i = None, []
        for j in range(tp):
            ex = {k: v[j * e_loc:(j + 1) * e_loc]
                  for k, v in p["experts"].items()}
            y_ij, a = ep_local(xt[i * t_loc:(i + 1) * t_loc], p["router"],
                               ex, shared, cfg, j * e_loc, tp)
            y_i = y_ij if y_i is None else y_i + y_ij
            aux_i.append(a)
        ys.append(y_i)
        auxs.append(torch.stack(aux_i).mean())
    y = torch.cat(ys) if nb > 1 else ys[0]
    aux = torch.stack(auxs).mean() if nb > 1 else auxs[0]
    return y.reshape(b, s, d).to(x.dtype), aux


#: bytes each rank staged for the expert-parallel all-reduce, per call
#: (phase 10 (e) holds them to the dry run's collective bytes)
staged_bytes: list[int] = []


def _rank_reduce(act, y, aux, tp, bd):
    """One all-reduce over the ``model`` group of the partial output and
    the aux loss side by side (aux then / tp), then the aux averaged over
    the batch axes; through host memory when the ranks stage."""
    import torch.distributed as dist
    ranks, groups = act.ranks, act.groups
    buf = torch.cat([y.reshape(-1).float() if y.dtype != torch.float32
                     else y.reshape(-1), aux.reshape(1).float()])
    if tp > 1:
        host = buf.cpu() if ranks.staged else buf
        staged_bytes.append(host.numel() * host.element_size())
        dist.all_reduce(host, group=groups["model"])
        buf = host.to(buf.device) if ranks.staged else host
    y = buf[:-1].reshape(y.shape).to(y.dtype)
    aux = buf[-1] / tp
    for a in bd:
        n = act.mesh.shape[a]
        if n > 1:
            host = aux.reshape(1).cpu() if ranks.staged else aux.reshape(1)
            dist.all_reduce(host, group=groups[a])
            aux = (host.to(buf.device) if ranks.staged else host)[0] / n
    return y, aux


def _ep_dtensor(p, x, cfg: ModelConfig, dm, ep: bool = True):
    """:func:`apply_moe_ep` on the dry run's DTensors (``local_map``, the
    counterpart of ``shard_map``): tokens over the batch axes, experts over
    ``model`` (``ep``) or, where the expert count does not divide it, each
    expert's hidden width over ``model``.  Outside the gate it stands in
    for the capacity dispatch, whose global sort and scatters DTensor has
    no rules for: see :func:`dtensor_formulation`."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    m = cfg.moe
    b, s, d = x.shape
    names = tuple(dm.mesh_dim_names)
    mi = names.index("model")
    tp = dm.shape[mi]
    bd = [i for i, a in enumerate(names) if a in ("pod", "data")]
    nb = int(np.prod([dm.shape[i] for i in bd])) if bd else 1
    # the batch over the batch axes (a mesh dim of one device: replicated)
    tok = [Shard(0) if i in bd and b % nb == 0 and dm.shape[i] > 1
           else Replicate() for i in range(len(names))]
    rep = [Replicate()] * len(names)

    def w_pl(name):
        if ep:
            dim = 0
        else:           # the hidden width: (E, d, f) up/gate, (E, f, d) down
            dim = 1 if name == "down" else 2
        return [Shard(dim) if i == mi else Replicate()
                for i in range(len(names))]

    names_e = sorted(p["experts"])
    shared = p.get("shared")
    names_s = sorted(shared) if shared is not None else []

    def local(xl, router, *ws):
        xt = xl.reshape(-1, d)
        experts = dict(zip(names_e, ws[:len(names_e)]))
        sh = dict(zip(names_s, ws[len(names_e):])) if names_s else None
        # ep: this device's experts; else every expert, a 1/tp slice of
        # each one's width
        lo = dm.get_local_rank("model") * (m.n_experts // tp) if ep else 0
        y, aux = ep_local(xt, router, experts, sh, cfg, lo, tp if ep else 1)
        buf = torch.cat([y.reshape(-1).float(), aux.reshape(1).float()])
        if tp > 1:
            buf = funcol.all_reduce(buf, "sum", (dm, mi))
        y = buf[:-1].reshape(xl.shape).to(y.dtype)
        aux = buf[-1] / tp
        for i in bd:
            if dm.shape[i] > 1:
                aux = funcol.all_reduce(aux, "sum", (dm, i)) / dm.shape[i]
        return y, aux

    w_in = [w_pl(n) for n in names_e]
    if ep:
        w_in += [rep for _ in names_s]
    else:
        w_in += [w_pl(n) for n in names_s]
    args = [p["experts"][n] for n in names_e] + \
        [shared[n] for n in names_s]
    return hints.local_call(local, (x, p["router"], *args),
                            (tok, rep, *w_in), (tok, rep), dm)


def ep_gate(mesh, cfg: ModelConfig, tokens: int) -> bool:
    """The JAX package's gate for the expert-parallel formulation."""
    return (mesh is not None and "model" in mesh.axis_names
            and cfg.moe.n_experts % mesh.shape["model"] == 0
            and tokens >= EP_MIN_TOKENS
            and tokens % max(int(np.prod([mesh.shape[a]
                                          for a in mesh.axis_names
                                          if a in ("pod", "data")])), 1)
            == 0)


#: what the dry run's DTensor carrier runs, by :func:`dtensor_formulation`
DTENSOR_FORMULATIONS = {
    "ep": "the reference's expert-parallel formulation (apply_moe_ep_shmap)",
    "ep-standin": "a stand-in: the reference runs the capacity dispatch "
                  "(below its gate); here expert-parallel, a capacity of each "
                  "batch shard's tokens per expert and one all-reduce over "
                  "model, where the dispatch's capacity is of all tokens",
    "width-standin": "a stand-in: the reference runs the capacity dispatch "
                     "(the expert count does not divide model); here every "
                     "expert's hidden width split over model, a capacity of "
                     "each batch shard's tokens per expert and one "
                     "all-reduce over model, where the dispatch's capacity "
                     "is of all tokens",
}


def dtensor_formulation(mesh, cfg: ModelConfig, tokens: int) -> str:
    """The key of :data:`DTENSOR_FORMULATIONS` that :func:`apply_moe` runs
    on DTensors over ``mesh`` (with a ``model`` axis) for a layer input of
    ``tokens`` tokens."""
    if ep_gate(mesh, cfg, tokens):
        return "ep"
    if cfg.moe.n_experts % mesh.shape["model"] == 0:
        return "ep-standin"
    return "width-standin"


def apply_moe(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux_loss): :func:`apply_moe_ep` under the gate
    (:func:`ep_gate`), else the capacity dispatch below.

    The fp32 softmax router picks each token's ``top_k`` experts (in
    descending order, as ``jax.lax.top_k``) and renormalizes their
    weights.  A stable argsort of the expert ids ranks each assignment
    within its expert, token by token; an assignment ranked at or past the
    capacity is dropped (it writes nothing, JAX's ``mode="drop"``, and its
    weight is 0).  The kept ones go to an ``(E, cap, d)`` buffer, every
    expert's MLP runs as one batched product, and each token gathers and
    weighs its experts' outputs.  Shared experts see every token.  The aux
    loss is Switch's load-balance term."""
    mesh = hints.active_mesh()
    tokens = x.shape[0] * x.shape[1]
    act = hints.active()
    if act is not None and act.ranks is not None:
        tokens *= _batch_shards(mesh)[1]    # a rank holds its batch shard
    if ep_gate(mesh, cfg, tokens):
        return apply_moe_ep(p, x, cfg)
    if hints.is_dtensor(x) and "model" in mesh.axis_names:
        # a stand-in for the capacity dispatch (dtensor_formulation)
        return _ep_dtensor(p, x, cfg, act.device_mesh,
                           ep=cfg.moe.n_experts % mesh.shape["model"] == 0)
    return _apply_moe_gspmd(p, x, cfg)


def _apply_moe_gspmd(p, x, cfg: ModelConfig):
    """The capacity dispatch (the JAX package's GSPMD path)."""
    m = cfg.moe
    b, s, d = x.shape
    tokens = b * s
    E, k = m.n_experts, m.top_k
    xt = x.reshape(tokens, d)
    probs, top_p, top_e = _route(xt, p["router"], m)       # (T, E), (T, k)
    cap = capacity(tokens, m)
    A = tokens * k
    flat_e = top_e.reshape(A)
    pos = positions(flat_e, E)
    keep = pos < cap                                       # (A,)
    if routing_log is not None:
        routing_log.append((top_e, keep.reshape(tokens, k)))

    slot = flat_e * cap + torch.clamp(pos, max=cap - 1)    # (A,)
    expert_in = x.new_zeros((E * cap, d))
    expert_in.index_copy_(0, slot[keep],
                          xt.repeat_interleave(k, dim=0)[keep])
    expert_in = hints.hint(expert_in.reshape(E, cap, d), "model", None, None)
    expert_out = hints.hint(apply_mlp(p["experts"], expert_in, cfg.mlp),
                            "model", None, None)           # (E, cap, d)
    gathered = hints.hint_tokens(
        expert_out.reshape(E * cap, d)[slot].reshape(tokens, k, d))
    w = (top_p * keep.reshape(tokens, k)).to(x.dtype)
    y = torch.einsum("tkd,tk->td", gathered, w)

    if m.n_shared:
        y = y + apply_mlp(p["shared"], xt[None], cfg.mlp).sum(0)

    return y.reshape(b, s, d).to(x.dtype), _aux(probs, top_e, m)
