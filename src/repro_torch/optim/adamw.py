"""AdamW over ShardedTensors: the numpy half of ``repro/optim/adamw.py``.

The reference module also holds the jax AdamW of the plain model stack
(``init_opt_state`` / ``apply_updates``); the port keeps only what
``Session.train_step`` runs: :class:`AdamWConfig` and the per-shard host
update, copied with ``repro.`` imports rewritten to ``repro_torch.``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


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
            t = np.empty_like(P)
            S = np.empty_like(P)
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
        G *= scale                              # g = g * scale
        M *= b1                                 # m = b1*m + omb1*g
        np.multiply(G, omb1, out=t)
        M += t
        V *= b2                                 # v = b2*v + (omb2*g)*g
        np.multiply(G, omb2, out=t)
        t *= G
        V += t
        np.divide(M, bc1, out=S)                # (m/bc1)/(sqrt(v/bc2)+eps)
        np.divide(V, bc2, out=t)
        np.sqrt(t, out=t)
        t += eps
        S /= t
        np.multiply(P, wd, out=t)               # step += wd*p
        S += t
        S *= lr                                 # p -= lr*step
        P -= S
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
