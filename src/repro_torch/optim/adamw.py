"""AdamW: the PyTorch counterpart of ``repro/optim/adamw.py``.

Two halves, as in the reference module:

* the plain model stack's AdamW (``init_opt_state`` / ``_schedule`` /
  ``apply_updates``, the reference's jax half, :33-73) over a tree of
  tensors, in the same order of operations, updating parameters and state
  in place;
* AdamW over ShardedTensors (``init_sharded_state`` ..
  ``sharded_apply_updates``), the per-shard host update that
  ``Session.train_step`` runs, copied with ``repro.`` imports rewritten to
  ``repro_torch.``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params):
    """fp32 m and v shaped as the parameters, and the step ``count``, an
    int32 scalar on the parameters' device, as the reference keeps it."""
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _schedule(cfg: AdamWConfig, count):
    """Linear warmup to ``cfg.lr``: an fp32 scalar tensor."""
    warm = torch.clamp(count.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: AdamWConfig):
    """AdamW step -> (params, opt_state, {"grad_norm", "lr"}), every metric
    an fp32 scalar tensor on the parameters' device.

    The reference's order of operations: the global norm from the per-leaf
    square sums added in tree order, the clip scale, m and v, the bias
    corrections ``1 - b ** count`` on fp32 scalars, the warmup lr, then
    ``p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)``.  Unlike the
    reference, the parameters and the state are updated in place (and the
    fp32 gradients serve as scratch), so a step holds one copy of each; the
    trees returned are the ones given."""
    count = opt_state["count"] + 1
    leaves = tree_leaves(grads)
    sq = torch.sum(torch.square(leaves[0].float()))
    for g in leaves[1:]:
        sq = sq + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    c = count.float()
    bc1 = 1 - cfg.b1 ** c
    bc2 = 1 - cfg.b2 ** c
    lr = _schedule(cfg, count)

    def upd(p, g, m, v):
        g = g.float()                                   # scratch from here
        g.mul_(scale)                                   # g = g * scale
        t = g * (1 - cfg.b1)
        m.mul_(cfg.b1).add_(t)                          # m = b1 m + (1-b1) g
        torch.mul(g, 1 - cfg.b2, out=t).mul_(g)
        v.mul_(cfg.b2).add_(t)                          # v = b2 v + (1-b2) g g
        torch.div(v, bc2, out=t).sqrt_().add_(cfg.eps)
        step = torch.div(m, bc1, out=g).div_(t)         # (m/bc1) / (.. + eps)
        p32 = p.float()
        step.add_(torch.mul(p32, cfg.weight_decay, out=t))  # + wd p
        p32.sub_(step.mul_(lr))                         # p - lr step
        if p32 is not p:
            p.copy_(p32)

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# sharded AdamW over ShardedTensors (api Session.train_step)
# ---------------------------------------------------------------------------
#
# The graph-IR training step produces gradients as per-device
# ShardedTensors whose annotations MATCH the parameters' (backward's
# grad-reduce comm guarantees it: Partial grads are all-reduced /
# reduce-scattered onto the parameter placement).  The update is
# therefore elementwise per shard — replicas stay bitwise in sync
# because every device applies identical numpy arithmetic to identical
# inputs, which is also what makes the executors' train_steps
# bit-comparable.  The math mirrors the reference's jax ``apply_updates``
# (same clip, warmup, bias correction and decoupled weight decay).

def init_sharded_state(params):
    """Optimizer state mirroring a ``{name: ShardedTensor}`` weight dict
    (fp32 m/v shards under the SAME annotations — ZeRO-3 storage when
    the params are sharded, ZeRO-1 when only the states are)."""
    import numpy as np

    from repro_torch.core.simulator import ShardedTensor

    def zeros_like(st):
        return ShardedTensor(
            st.shape, st.annot,
            {d: np.zeros(a.shape, np.float32)
             for d, a in st.parts.items()})

    return {"m": {n: zeros_like(st) for n, st in params.items()},
            "v": {n: zeros_like(st) for n, st in params.items()},
            "count": 0}


_TILE_GROUP_CACHE: dict = {}


def _tile_groups(st):
    """Group a ShardedTensor's devices by the global tile their shard
    covers: one entry per distinct tile, listing the tile's replicas.
    Returns ``None`` when the shards are not plain tiles (any Partial
    layout — shards are then summands, not copies), so callers fall
    back to per-device handling.  Pure geometry — memoized on the
    (annotation, shape) pair, which the optimizer revisits every step."""
    from repro_torch.core.annotations import DUP, PARTIAL

    annot = st.annot
    ck = (annot, st.shape)
    hit = _TILE_GROUP_CACHE.get(ck, False)
    if hit is not False:
        return hit
    out = None
    if annot.hdim != PARTIAL:
        groups: dict[tuple, list[int]] = {}
        for g, (dg, ds) in enumerate(zip(annot.dgs, annot.dss)):
            if ds.has_partial:
                groups = None
                break
            slab = annot.subgroup_shape(g, st.shape)
            key_g = 0 if annot.hdim == DUP else g
            for pos, dev in enumerate(dg):
                box = ds.local_box(pos, slab)
                groups.setdefault((key_g, box), []).append(dev)
        if groups is not None:
            out = list(groups.values())
    _TILE_GROUP_CACHE[ck] = out
    return out


def sharded_grad_norm(grads) -> float:
    """Global gradient norm over ``{name: ShardedTensor}`` — replicas
    counted once, fp32 accumulation like :func:`apply_updates`.

    Computed tile-by-tile from the shards in hand (split dims tile the
    global value, so the squared norm decomposes exactly); only Partial
    layouts — where shards are summands — reconstruct via ``gather``."""
    import numpy as np

    from repro_torch.core.simulator import gather

    acc = np.float32(0.0)
    for st in grads.values():
        tiles = _tile_groups(st)
        if tiles is None:
            g = np.asarray(gather(st, check_dups=False), np.float32)
            acc = acc + np.sum(np.square(g), dtype=np.float32)
        else:
            for devs in tiles:
                g = np.asarray(st.parts[devs[0]], np.float32)
                acc = acc + np.sum(np.square(g), dtype=np.float32)
    return float(np.sqrt(acc))


#: elements of the flat buffers that the sharded update's elementwise
#: chain takes at a time (16 MB of fp32 scratch, twice)
FLAT_CHUNK = 1 << 22


def sharded_apply_updates(params, grads, opt_state, cfg: AdamWConfig):
    """AdamW over sharded weights: returns ``(new_params, new_state,
    metrics)`` with the same structure; deterministic numpy, identical
    for both executors given identical gradient shards."""
    import numpy as np

    from repro_torch.core.simulator import ShardedTensor

    if set(params) != set(grads):
        raise ValueError(
            f"gradient names {sorted(grads)} do not match parameters "
            f"{sorted(params)}")
    count = opt_state["count"] + 1
    c = np.float32(count)
    bc1 = np.float32(1) - np.float32(cfg.b1) ** c
    bc2 = np.float32(1) - np.float32(cfg.b2) ** c
    warm = min(float(count) / max(cfg.warmup_steps, 1), 1.0)
    lr = np.float32(cfg.lr * warm)

    b1, omb1 = np.float32(cfg.b1), np.float32(1 - cfg.b1)
    b2, omb2 = np.float32(cfg.b2), np.float32(1 - cfg.b2)
    eps, wd = np.float32(cfg.eps), np.float32(cfg.weight_decay)

    def upd(arr, g_arr, m_prev, v_prev):
        g = np.asarray(g_arr, np.float32) * scale
        m_ = b1 * m_prev + omb1 * g
        v_ = b2 * v_prev + omb2 * g * g
        step = (m_ / bc1) / (np.sqrt(v_ / bc2) + eps)
        step = step + wd * arr.astype(np.float32)
        return (arr.astype(np.float32) - lr * step).astype(arr.dtype), \
            m_, v_

    # replicas of a tile receive bit-identical updates (identical numpy
    # arithmetic on identical inputs), so each tile is computed once and
    # its result arrays shared across the replica devices — the same
    # class-dedup the lowered executors apply to compute.  fp32 tiles
    # additionally batch into ONE flat buffer so the ~16-op elementwise
    # chain dispatches once per STEP instead of once per tile (the tiles
    # are small enough that numpy per-call overhead, not bandwidth,
    # dominates).  Per-element operation order is identical to ``upd``,
    # so the batched path is bit-for-bit the per-tile path.
    new_params: dict[str, object] = {}
    new_m: dict[str, object] = {}
    new_v: dict[str, object] = {}
    pp_all = {name: {} for name in params}
    mm_all = {name: {} for name in params}
    vv_all = {name: {} for name in params}
    jobs: list[tuple] = []      # (name, devs, p, g, m, v) fp32 tiles
    fb_tiles: list[tuple] = []  # deduped tiles on the per-tile path
    fb_names: list[str] = []    # tensors updated per device (Partial)
    for name, p in params.items():
        g_st, m_st = grads[name], opt_state["m"][name]
        v_st = opt_state["v"][name]
        tiles = _tile_groups(p)
        if tiles is not None and all(
                devs[0] in g_st.parts and devs[0] in m_st.parts
                and p.parts[devs[0]].dtype == np.float32
                and g_st.parts[devs[0]].dtype == np.float32
                for devs in tiles):
            for devs in tiles:
                d0 = devs[0]
                jobs.append((name, devs, p.parts[d0], g_st.parts[d0],
                             m_st.parts[d0], v_st.parts[d0]))
        elif tiles is not None and all(
                devs[0] in g_st.parts and devs[0] in m_st.parts
                for devs in tiles):
            for devs in tiles:
                d0 = devs[0]
                fb_tiles.append((name, devs, p.parts[d0],
                                 g_st.parts[d0], m_st.parts[d0],
                                 v_st.parts[d0]))
        else:                   # Partial shards: per-device update
            fb_names.append(name)
    # steady-state reuse: the views handed out below are contiguous
    # slices of the flat buffers IN JOB ORDER, so when the caller feeds
    # the previous step's params/state straight back (the training
    # loop), the flat P/M/V buffers already hold this step's inputs and
    # the update runs fully in place — no 3x whole-model concatenate.
    # Validated by base identity + byte offset per tile; any reshard,
    # switch() migration or fresh state fails the check and falls back
    # to the concat path.  In-place means the PREVIOUS step's param/
    # state views alias the updated values afterwards — the optimizer
    # consumes its inputs, like any in-place optimizer.
    prev = opt_state.get("_flat")
    flat_cache = None
    if jobs:
        layout = tuple((j[0], tuple(j[1]), j[2].size) for j in jobs)
        reuse = prev is not None and prev["layout"] == layout
        if reuse:
            Pb, Mb, Vb = prev["P"], prev["M"], prev["V"]
            pa = Pb.__array_interface__["data"][0]
            ma = Mb.__array_interface__["data"][0]
            va = Vb.__array_interface__["data"][0]
            off = 0
            for _, _, p0, _, m0, v0 in jobs:
                want = off * 4
                if not (p0.base is Pb and m0.base is Mb
                        and v0.base is Vb
                        and p0.__array_interface__["data"][0] - pa == want
                        and m0.__array_interface__["data"][0] - ma == want
                        and v0.__array_interface__["data"][0] - va == want):
                    reuse = False
                    break
                off += p0.size
        if reuse:
            P, M, V = prev["P"], prev["M"], prev["V"]
            G, t, S = prev["G"], prev["t"], prev["S"]
        else:
            P, M, V = (np.concatenate([j[i].ravel() for j in jobs])
                       for i in (2, 4, 5))
            G = np.empty_like(P)
            # the chain's scratch covers one chunk of the flat buffers
            t = np.empty(min(P.size, FLAT_CHUNK), P.dtype)
            S = np.empty_like(t)
        off = 0                 # grads land in G in ONE pass per tile
        for _, _, _, g0, _, _ in jobs:
            n = g0.size
            np.copyto(G[off:off + n].reshape(g0.shape), g0)
            off += n
        flat_cache = {"layout": layout, "P": P, "M": M, "V": V,
                      "G": G, "t": t, "S": S}

    # global grad norm: one BLAS dot over the flat buffer; tensors off
    # the flat path contribute through the tile/gather logic of
    # :func:`sharded_grad_norm`.  fp32 accumulation either way.
    sq = np.float32(np.dot(G, G)) if jobs else np.float32(0.0)
    fb_norm = {j[0] for j in fb_tiles} | set(fb_names)
    if fb_norm:
        sq = sq + np.float32(
            sharded_grad_norm({n: grads[n] for n in fb_norm})) ** 2
    gnorm = np.sqrt(sq)
    scale = np.minimum(np.float32(1.0),
                       np.float32(cfg.grad_clip) / (gnorm + np.float32(1e-9)))

    for name, devs, p0, g0, m0, v0 in fb_tiles:
        p_, m_, v_ = upd(p0, g0, m0, v0)
        for dev in devs:
            pp_all[name][dev] = p_
            mm_all[name][dev] = m_
            vv_all[name][dev] = v_
    for name in fb_names:
        p, g_st = params[name], grads[name]
        m_st, v_st = opt_state["m"][name], opt_state["v"][name]
        for dev, arr in p.parts.items():
            pp_all[name][dev], mm_all[name][dev], vv_all[name][dev] = \
                upd(arr, g_st.parts[dev], m_st.parts[dev],
                    v_st.parts[dev])

    if jobs:
        # the elementwise chain, a chunk of the flat buffers at a time:
        # every element sees the same operations in the same order, so
        # the chunking changes no bit and bounds the scratch
        for a in range(0, P.size, FLAT_CHUNK):
            b = min(a + FLAT_CHUNK, P.size)
            p_, g_, m_, v_ = P[a:b], G[a:b], M[a:b], V[a:b]
            t_, S_ = t[:b - a], S[:b - a]
            g_ *= scale                         # g = g * scale
            m_ *= b1                            # m = b1*m + omb1*g
            np.multiply(g_, omb1, out=t_)
            m_ += t_
            v_ *= b2                            # v = b2*v + (omb2*g)*g
            np.multiply(g_, omb2, out=t_)
            t_ *= g_
            v_ += t_
            np.divide(m_, bc1, out=S_)          # (m/bc1)/(sqrt(v/bc2)+eps)
            np.divide(v_, bc2, out=t_)
            np.sqrt(t_, out=t_)
            t_ += eps
            S_ /= t_
            np.multiply(p_, wd, out=t_)         # step += wd*p
            S_ += t_
            S_ *= lr                            # p -= lr*step
            p_ -= S_
        off = 0
        for name, devs, p0, _, _, _ in jobs:
            n = p0.size
            p_ = P[off:off + n].reshape(p0.shape)
            m_ = M[off:off + n].reshape(p0.shape)
            v_ = V[off:off + n].reshape(p0.shape)
            off += n
            for dev in devs:
                pp_all[name][dev] = p_
                mm_all[name][dev] = m_
                vv_all[name][dev] = v_
    for name, p in params.items():
        new_params[name] = ShardedTensor(p.shape, p.annot, pp_all[name])
        new_m[name] = ShardedTensor(p.shape, p.annot, mm_all[name])
        new_v[name] = ShardedTensor(p.shape, p.annot, vv_all[name])
    metrics = {"grad_norm": float(gnorm), "lr": float(lr)}
    new_state = {"m": new_m, "v": new_v, "count": count}
    if flat_cache is not None:
        new_state["_flat"] = flat_cache
    return new_params, new_state, metrics
