"""In-model sharding hints: the PyTorch counterpart of
``repro/sharding/hints.py``.

A mesh is activated explicitly, with :func:`use_mesh` (the counterpart of
``with mesh:``).  Model code calls the hints unconditionally: with no
active mesh, on a plain tensor, or when the requested axes do not exist or
do not divide, :func:`hint` returns its input itself.  On a DTensor under
an active mesh it redistributes to the placements the reference's
``with_sharding_constraint`` would pin.

The active mesh carries up to two carriers of the same logical mesh:

* ``device_mesh``: a ``DeviceMesh`` over the dry run's fake world; the
  model's tensors are DTensors, and plain tensors that meet them (masks,
  positions, constants) count as replicated (DTensor's
  ``implicit_replication``),
* ``ranks``: the process groups of real ranks along each axis
  (:meth:`~repro_torch.launch.mesh.LogicalMesh.rank_groups`); the tensors
  are plain, each rank's own shard, and only layers that know the mesh
  (:func:`repro_torch.models.moe.apply_moe_ep`) use it.

The other helpers go beyond the reference, for what GSPMD does on its
own and DTensor does not; each is the identity on plain tensors:
:func:`gather_weights` (FSDP: a block's weights gathered over the batch
axes where it starts), :func:`split_heads` (a width over ``model`` split
into a head count that ``model`` does not divide is gathered first; GSPMD
pads such a split, DTensor refuses it), :func:`pin_residual` and
:func:`keep_layout` (a layout pinned in the forward and the backward),
:func:`like`, :func:`unshard`, :func:`place` (one mesh dim at a time) and
:func:`shardwise` (a function on each device's shards: ``local_map``, the
counterpart of ``shard_map``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ActiveMesh:
    mesh: object                  # a LogicalMesh
    device_mesh: object = None    # a DeviceMesh over the dry run's world
    ranks: object = None          # this rank's RankMesh
    groups: dict | None = None    # axis -> this rank's process group


_ACTIVE: ActiveMesh | None = None


@contextlib.contextmanager
def use_mesh(mesh, *, device_mesh=None, ranks=None):
    """Activate ``mesh`` (a :class:`~repro_torch.launch.mesh.LogicalMesh`)
    for the hints and for :func:`~repro_torch.models.moe.apply_moe`, with
    at most one carrier: a ``device_mesh`` of the same axes, or this
    rank's ``ranks`` (a ``RankMesh`` of ``mesh.size`` ranks, whose groups
    along each axis are made here, collectively)."""
    global _ACTIVE
    if device_mesh is not None and ranks is not None:
        raise ValueError("a mesh has one carrier: device_mesh or ranks")
    if device_mesh is not None and (
            tuple(device_mesh.mesh_dim_names) != tuple(mesh.axis_names)
            or tuple(device_mesh.shape) != tuple(mesh.axis_sizes)):
        raise ValueError(f"device mesh {device_mesh} is not {mesh}")
    groups = mesh.rank_groups(ranks) if ranks is not None else None
    prev = _ACTIVE
    _ACTIVE = ActiveMesh(mesh, device_mesh, ranks, groups)
    try:
        with contextlib.ExitStack() as stack:
            if device_mesh is not None:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
            yield _ACTIVE
    finally:
        _ACTIVE = prev


def active() -> ActiveMesh | None:
    return _ACTIVE


def active_mesh():
    """The active logical mesh, or None."""
    return None if _ACTIVE is None else _ACTIVE.mesh


def batch_axes() -> tuple[str, ...] | None:
    m = active_mesh()
    if m is None:
        return None
    return tuple(a for a in ("pod", "data") if a in m.axis_names) or None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor under an active DeviceMesh."""
    if not torch.is_tensor(x) or _ACTIVE is None \
            or _ACTIVE.device_mesh is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(x, want):
    """DTensor ``x`` redistributed to ``want`` one mesh dim at a time,
    partial sums first, each step one collective over one mesh dim.
    (DTensor's own planner, given several mesh dims to change at once,
    can route through gathering a dim that keeps its placement.)"""
    want = tuple(want)
    cur = list(x.placements)
    order = sorted(range(len(want)), key=lambda i: not cur[i].is_partial())
    for i in order:
        if cur[i] != want[i]:
            cur[i] = want[i]
            x = x.redistribute(x.device_mesh, tuple(cur))
    return x


def local_call(fn, args, in_placements, out_placements, device_mesh):
    """``local_map(fn)`` on ``args`` (DTensors moved to ``in_placements``
    by :func:`place` first; ``None`` passes an argument through)."""
    from torch.distributed.tensor.experimental import local_map
    args = tuple(place(a, pl) if pl is not None and is_dtensor(a) else a
                 for a, pl in zip(args, in_placements))
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     device_mesh=device_mesh,
                     redistribute_inputs=True)(*args)


class _Pin(torch.autograd.Function):
    """Redistribute to ``want`` in the forward, and the gradient to the
    same placements in the backward, as JAX transposes a sharding
    constraint into the same constraint on the cotangent."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return place(x, want)

    @staticmethod
    def backward(ctx, g):
        return place(g, ctx.want), None


def _pin(x, want):
    """``x`` at ``want``, and its gradient too (also where ``x`` is at
    ``want`` already: the backward is pinned all the same)."""
    if not x.requires_grad:
        return x if tuple(x.placements) == tuple(want) else \
            place(x, want)
    return _Pin.apply(x, tuple(want))


def hint(x, *spec):
    """Pin ``x`` to ``P(*spec)`` if the active mesh has the named axes and
    every sharded dim divides (the reference's ``fixed`` rule); otherwise,
    and on anything but a DTensor, ``x`` itself."""
    if active_mesh() is None:
        return x
    fixed = _fixed(x.shape, spec)
    if all(a is None for a in fixed) or not is_dtensor(x):
        return x
    from .rules import P, to_placements
    return _pin(x, to_placements(P(*fixed), x.device_mesh))


def hint_tokens(x):
    """Shard a (tokens, ...) tensor's leading dim over the batch axes."""
    bd = batch_axes()
    return hint(x, bd) if bd else x


def pin_residual(x):
    """A DTensor residual stream (B, S, d) pinned to the batch axes,
    replicated over the rest.  Left to itself, DTensor reduce-scatters a
    row-parallel product's partial sums over the sequence, and then cannot
    run the next products on (batch x sequence) shards; GSPMD all-reduces
    there.  The identity on anything else."""
    if not is_dtensor(x) or x.dim() != 3:
        return x
    from .rules import P, to_placements
    bd = batch_axes()
    n = int(np.prod([_ACTIVE.mesh.shape[a] for a in bd or ()]))
    return _pin(x, to_placements(P(bd if bd and x.shape[0] % n == 0
                                     else None), x.device_mesh))


# --- what GSPMD does on its own -------------------------------------------

def _replicate_dims(x, mesh_dims):
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if i in mesh_dims else p
                 for i, p in enumerate(x.placements))
    return place(x, want)


def gather_weights(tree):
    """FSDP: each DTensor leaf of ``tree`` gathered over the batch axes
    (its ``model`` shards kept), as a block's weights are gathered where
    the block starts; the backward reduce-scatters their gradients.
    Anything else comes back as it is."""
    bd = batch_axes()
    if not bd or _ACTIVE.device_mesh is None:
        return tree
    names = tuple(_ACTIVE.device_mesh.mesh_dim_names)
    dims = {names.index(a) for a in bd}

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, list):
            return [rec(v) for v in t]
        return _replicate_dims(t, dims) if is_dtensor(t) else t

    return rec(tree)


def keep_layout(x):
    """A DTensor whose gradient must come back in its own layout (a width
    merged from heads that ``model`` does not divide, which the backward
    would otherwise view as heads while sharded); anything else as it
    is."""
    return _pin(x, tuple(x.placements)) if is_dtensor(x) else x


def like(x, ref):
    """DTensor ``x`` laid out as ``ref`` (a gradient as its parameter: the
    partial sums of a replicated weight's gradient reduced, as GSPMD gives
    a gradient its parameter's sharding); the identity on anything else."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(ref.placements):
        return x
    return place(x, ref.placements)


def unshard(x, axis: str):
    """A DTensor gathered over mesh axis ``axis`` (where its other operand
    is sharded over that axis along another dim); the identity on anything
    else."""
    if not is_dtensor(x) or axis not in x.device_mesh.mesh_dim_names:
        return x
    return _replicate_dims(x, {x.device_mesh.mesh_dim_names.index(axis)})


def _fixed(shape, spec):
    """The reference's ``fixed`` rule: axes that exist and divide."""
    m = _ACTIVE.mesh
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        axes = () if axis is None else \
            axis if isinstance(axis, tuple) else (axis,)
        ok = axes and all(a in m.axis_names for a in axes) and \
            dim % int(np.prod([m.shape[a] for a in axes])) == 0
        out.append(axis if ok else None)
    return out


def shardwise(fn, args, in_specs, out_shapes, out_specs):
    """``fn(*args)``, run on each device's shards when the first argument
    is a DTensor under the active DeviceMesh (the counterpart of
    ``shard_map``; ``local_map`` moves the inputs to ``in_specs`` first).
    Each spec keeps only the axes that exist and divide its tensor's
    shape (``out_shapes`` for the outputs); a ``None`` spec passes a
    non-tensor argument through."""
    if not is_dtensor(args[0]):
        return fn(*args)
    from .rules import P, to_placements
    dm = _ACTIVE.device_mesh

    def pl(shape, spec):
        return None if spec is None else \
            list(to_placements(P(*_fixed(shape, spec)), dm))

    ins = tuple(pl(a.shape if torch.is_tensor(a) else (), sp)
                for a, sp in zip(args, in_specs))
    outs = [pl(sh, sp) for sh, sp in zip(out_shapes, out_specs)]
    return local_call(fn, args, ins,
                      tuple(outs) if len(outs) > 1 else outs[0], dm)


def split_heads(x, n: int, dim: int = -1):
    """``x`` ready to have dim ``dim`` (n * w) viewed as (n, w): a DTensor
    whose dim ``dim`` is sharded over a mesh dim that does not divide ``n``
    is gathered over that mesh dim first."""
    if not is_dtensor(x):
        return x
    dim = dim % x.dim()
    bad = {i for i, p in enumerate(x.placements)
           if p.is_shard() and p.dim == dim and n % x.device_mesh.shape[i]}
    return _replicate_dims(x, bad) if bad else x
