"""Annotation -> sharding specs, and the per-architecture rules of the
production mesh: the PyTorch counterpart of ``repro/sharding/rules.py``.

Two layers:

1. :func:`annot_to_spec` -- a (homogeneous, HSize=1) HSPMD annotation as a
   :class:`P`; :func:`spec_to_annot` the inverse.
2. :func:`param_specs` / :func:`batch_specs` / :func:`decode_state_specs`
   -- rule-based spec trees for the production mesh, rule for rule the
   reference's:
     - weights: FSDP over ``data`` x TP over ``model`` (replicated over
       ``pod``),
     - MoE experts: EP over ``model`` when n_experts divides, else TP
       inside each expert,
     - activations and caches: batch over (pod, data), heads or latent
       over ``model``,
     - non-divisible dims fall back to replication (:func:`_maybe`).

A mesh here is anything with ``shape`` (axis name -> size) and
``axis_names``: a :class:`~repro_torch.launch.mesh.LogicalMesh`.
:func:`to_placements` turns a spec into DTensor placements on a
``DeviceMesh`` of the same axes (the counterpart of ``to_named``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..core.annotations import DUP, HSPMD
from ..models.config import ModelConfig


class P(tuple):
    """A partition spec: one entry per tensor dim, each an axis name, a
    tuple of axis names (the first major), or ``None``; trailing dims left
    out are unsharded.  A one-axis tuple becomes the axis name, as
    ``jax.sharding.PartitionSpec`` makes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# HSPMD annotation <-> spec (HSize == 1)
# ---------------------------------------------------------------------------

def annot_to_spec(annot: HSPMD, axis_order: tuple[str, ...]) -> P:
    """Compile a single-subgroup annotation to a spec.

    ``axis_order`` names the mesh axes of the DS entries in order (the
    device-major decomposition must match the mesh's).  Duplicate entries
    map to unsharded mesh axes; Partial is rejected (a step's inputs and
    outputs cannot be partial-valued)."""
    if annot.hsize != 1:
        raise ValueError("annot_to_spec expects HSize == 1; specialize "
                         "heterogeneous annotations per subgroup")
    ds = annot.dss[0]
    if ds.has_partial:
        raise ValueError("Partial tensors cannot cross a step boundary")
    if len(axis_order) != len(ds.entries):
        raise ValueError(f"axis_order {axis_order} does not match DS "
                         f"entries {ds.entries}")
    ndim = 1 + max((d for d, _ in ds.entries if d >= 0), default=-1)
    spec: list = [None] * ndim
    for (d, n), axis in zip(ds.entries, axis_order):
        if d >= 0:
            spec[d] = axis
    return P(*spec)


def spec_to_annot(spec: P, mesh, shape: tuple[int, ...]) -> HSPMD:
    """The inverse bridge: a spec on ``mesh`` as an annotation over the
    mesh's device ids."""
    from ..core.annotations import spmd
    entries = []
    used = set()
    for d, axis in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        n = int(np.prod([mesh.shape[a] for a in axes]))
        entries.append((d, n))
        used.update(axes)
    dup = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                       if a not in used]))
    if dup > 1:
        entries.append((DUP, dup))
    return spmd(sorted(int(d) for d in np.ravel(mesh.devices)),
                dict(entries))


# ---------------------------------------------------------------------------
# production parameter rules
# ---------------------------------------------------------------------------

_2D_COL = re.compile(
    r"(wq|wk|wv|up|gate|in_proj|in_x|in_gate|gate_r|gate_i|wq_a|wq_b|"
    r"wkv_a|wkv_b|embed)$")
_2D_ROW = re.compile(r"(wo|out_proj|out|down|lm_head)$")


def _axes(axis) -> tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def _div(size: int, mesh, axis) -> bool:
    if axis is None:
        return True
    n = int(np.prod([mesh.shape[a] for a in _axes(axis)]))
    return size % n == 0


def _maybe(spec_dims, shape, mesh) -> P:
    """Drop non-divisible axis assignments (replicate those dims)."""
    return P(*(axis if _div(dim, mesh, axis) else None
               for dim, axis in zip(shape, spec_dims)))


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's shape; a Python int (a step counter the port keeps on the
    host, a 0-d array in the reference) is a scalar."""
    return tuple(leaf.shape) if torch.is_tensor(leaf) else ()


def _walk(tree, leaf_fn, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, leaf_fn, f"{path}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, leaf_fn, f"{path}{i}/") for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(_walk(v, leaf_fn, f"{path}{i}/")
                     for i, v in enumerate(tree))
    return leaf_fn(path[:-1], tree)


def param_specs(params, cfg: ModelConfig, mesh, mode: str = "train"):
    """The spec tree of the parameter tree (stacked layer groups: a leading
    layer axis is always unsharded).

    ``mode="serve"`` is the weight-stationary decode layout: weights are not
    sharded over ``data`` (no optimizer state and no gradient to justify
    FSDP).  Use it only when bf16 weights / TP fit beside the KV cache
    (:func:`serve_mode_fits` decides)."""
    fsdp = None if mode == "serve" else "data"
    tp = "model"

    def leaf_spec(path: str, leaf) -> P:
        shape = _shape(leaf)
        name = path.rsplit("/", 1)[-1]
        stacked = path.startswith("groups/")
        base = shape[1:] if stacked else shape
        lead = (None,) if stacked else ()

        def out(*dims):
            return _maybe(lead + dims, shape, mesh)

        if "experts" in path or "shared" in path:
            # (L, E, d, f) or (L, E, f, d)
            e = base[0]
            ep_ok = _div(e, mesh, tp)
            if name in ("up", "gate"):
                return out(tp, fsdp, None) if ep_ok else out(None, fsdp, tp)
            if name == "down":
                return out(tp, None, fsdp) if ep_ok else out(None, tp, fsdp)
        if len(base) == 2 and _2D_COL.search(name):
            return out(fsdp, tp)
        if len(base) == 2 and _2D_ROW.search(name):
            return out(tp, fsdp)
        if name == "router":
            return out(fsdp, None)
        if name == "conv_w":
            return out(None, tp)
        # norms, biases, scalars: replicated
        return P(*([None] * len(shape)))

    return _walk(params, leaf_spec)


def _nbytes(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    return 4     # a host-side step counter: an int32 scalar in the reference


def serve_mode_fits(params_struct, state_struct, mesh,
                    budget_bytes: int = 14 * 2**30) -> bool:
    """True when the weights / TP + the decode state's shard fit the
    budget, enabling the weight-stationary serve layout.  The budget is
    the reference's (14 GiB of a 16 GiB TPU v5e chip), kept so that both
    packages pick the same layout."""
    tp = mesh.shape.get("model", 1)
    nchips = int(np.prod(list(mesh.shape.values())))
    pbytes = sum(_nbytes(x) for x in _leaves(params_struct))
    sbytes = sum(_nbytes(x) for x in _leaves(state_struct))
    return pbytes / tp + sbytes / nchips < budget_bytes


def _leaves(tree) -> list:
    """Every leaf, Python ints included."""
    out: list = []
    _walk(tree, lambda _, x: out.append(x))
    return out


def _bdims(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_specs(batch, mesh):
    """Batch dim over (pod, data) when divisible; everything else local."""
    bdims = _bdims(mesh)

    def leaf(_, x):
        shape = _shape(x)
        if len(shape) == 0:
            return P()
        if len(shape) == 3 and shape[0] == 3:   # positions3 (3, B, S)
            return _maybe((None, bdims, None), shape, mesh)
        spec = [None] * len(shape)
        spec[0] = bdims
        return _maybe(tuple(spec), shape, mesh)

    return _walk(batch, leaf)


def decode_state_specs(state, cfg: ModelConfig, mesh):
    """KV caches: batch over (pod, data), the cache's sequence over
    ``model``; latent caches likewise; SSM and RG-LRU states shard their
    width dims over ``model``."""
    bdims = _bdims(mesh)
    tp = "model"

    def leaf(path, x):
        shape = _shape(x)
        name = path.rsplit("/", 1)[-1]
        if len(shape) == 0:
            return P()
        stacked = path.startswith("caches/")
        lead = (None,) if stacked else ()
        base = shape[1:] if stacked else shape
        if name in ("k", "v") and len(base) == 4:
            # (B, S, K, hd): the cache's sequence over model
            return _maybe(lead + (bdims, tp, None, None), shape, mesh)
        if name == "c_kv":
            return _maybe(lead + (bdims, tp, None), shape, mesh)
        if name == "k_rope":
            return _maybe(lead + (bdims, tp, None), shape, mesh)
        if name == "state" and len(base) == 4:
            # SSM state (B, h, p, n): heads over model
            return _maybe(lead + (bdims, tp, None, None), shape, mesh)
        if name in ("conv", "h"):
            spec = lead + (bdims,) + (None,) * (len(base) - 2) + (tp,)
            return _maybe(spec, shape, mesh)
        if name == "enc_out":
            return _maybe((bdims, None, tp), shape, mesh)
        spec = lead + (bdims,) + (None,) * (len(base) - 1)
        return _maybe(spec, shape, mesh)

    return _walk(state, leaf)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: P, device_mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``device_mesh``: ``Shard(d)``
    on each mesh dim that tensor dim ``d`` names, ``Replicate()`` on the
    rest.  A tuple entry shards one tensor dim over several mesh dims, the
    first major; DTensor splits a dim over several mesh dims in mesh-dim
    order (the earlier mesh dim major), so a tuple must name its axes in
    the mesh's order, or the device-to-shard map would differ from JAX's
    (DTensor's ``_StridedShard``) -- it raises instead.  A mesh dim of one
    device shards nothing and stays ``Replicate()``: DTensor would copy a
    tensor onto itself to move between the two."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    sizes = tuple(device_mesh.shape)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(
                f"spec entry {entry} names its axes out of the mesh's order "
                f"{names}: DTensor would shard it major-to-minor in mesh "
                f"order")
        for m in pos:
            if sizes[m] > 1:
                out[m] = Shard(d)
    return tuple(out)
