"""Virtual-device shard simulator.

Executes :class:`~repro_torch.core.plan.CommPlan` stages on a plain
``dict[device_id, np.ndarray]`` so the entire hierarchical communication
resolution layer (paper §4) can be validated *numerically* on CPU — for any
number of virtual devices, including the paper's 48-rank cases.

Semantics:

* *Split*/*Duplicate* shards hold the exact sub-box of the global value.
* *Partial* shards hold random summands that add up to the global value
  (random decomposition makes silent drop/double-count bugs visible).
* ``apply_plan`` executes each stage: contributed slice-groups are reduced
  or copied and delivered; any region of a device's next-annotation box not
  covered by a delivery is filled from the device's own previous shard
  (the paper's "local copy" path), and full coverage is asserted.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .annotations import DUP, PARTIAL, HSPMD
from .plan import (Box, CommPlan, box_contains, box_intersect, box_shape,
                   rel_slices)


@dataclasses.dataclass
class ShardedTensor:
    shape: tuple[int, ...]
    annot: HSPMD
    parts: dict[int, np.ndarray]

    @property
    def dtype(self):
        return next(iter(self.parts.values())).dtype


def _decompose(value: np.ndarray, k: int, rng: np.random.Generator) -> list[np.ndarray]:
    """Random summand decomposition: k arrays that sum to ``value``."""
    if k == 1:
        return [value]
    pieces = [rng.normal(size=value.shape).astype(value.dtype) for _ in range(k - 1)]
    pieces.append(value - sum(pieces))
    return pieces


def scatter(value: np.ndarray, annot: HSPMD,
            rng: np.random.Generator | None = None,
            decompose=None) -> ShardedTensor:
    """Shard a global array according to ``annot``.

    ``decompose(value, k, rng) -> [summands]`` overrides the random
    Partial decomposition (e.g. integer summands make reductions
    order-insensitive for differential tests against fast collectives).
    """
    rng = rng or np.random.default_rng(0)
    decompose = decompose or _decompose
    shape = tuple(value.shape)

    # top tier: one slab (or summand) per subgroup
    if annot.hdim == PARTIAL:
        slabs = decompose(value, annot.hsize, rng)
        slab_boxes = [tuple((0, s) for s in shape)] * annot.hsize
    else:
        slabs, slab_boxes = [], []
        for g in range(annot.hsize):
            if annot.hdim >= 0:
                lo, hi = annot._hdim_bounds(shape[annot.hdim])[g]
                idx = tuple(slice(lo, hi) if d == annot.hdim else slice(None)
                            for d in range(len(shape)))
                box = tuple((lo, hi) if d == annot.hdim else (0, s)
                            for d, s in enumerate(shape))
            else:
                idx = tuple(slice(None) for _ in shape)
                box = tuple((0, s) for s in shape)
            slabs.append(value[idx])
            slab_boxes.append(box)

    parts: dict[int, np.ndarray] = {}
    for g, (dg, ds) in enumerate(zip(annot.dgs, annot.dss)):
        slab = slabs[g]
        kp = ds.get(PARTIAL)
        summands = decompose(slab, kp, rng)
        for pos, dev in enumerate(dg):
            c = ds.coords(pos)
            piece = summands[c.get(PARTIAL, 0)]
            box = ds.local_box(pos, slab.shape)
            parts[dev] = piece[tuple(slice(lo, hi) for lo, hi in box)].copy()
    return ShardedTensor(shape, annot, parts)


def gather(st: ShardedTensor, check_dups: bool = True,
           atol: float = 1e-6) -> np.ndarray:
    """Reconstruct the global array; asserts duplicate copies agree."""
    annot, shape = st.annot, st.shape
    slabs = []
    for g, (dg, ds) in enumerate(zip(annot.dgs, annot.dss)):
        slab_shape = annot.subgroup_shape(g, shape)
        kp = ds.get(PARTIAL)
        acc = np.zeros(slab_shape, dtype=np.float64)
        seen: dict[tuple, np.ndarray] = {}
        for pos, dev in enumerate(dg):
            c = ds.coords(pos)
            box = ds.local_box(pos, slab_shape)
            key = (box, c.get(PARTIAL, 0))
            arr = st.parts[dev]
            if key in seen:
                if check_dups:
                    np.testing.assert_allclose(arr, seen[key], atol=atol,
                                               err_msg=f"dup mismatch dev {dev}")
                continue
            seen[key] = arr
            acc[tuple(slice(lo, hi) for lo, hi in box)] += arr
        slabs.append(acc)

    if annot.hdim == PARTIAL:
        return sum(slabs)
    if annot.hdim == DUP:
        if check_dups:
            for s in slabs[1:]:
                np.testing.assert_allclose(s, slabs[0], atol=atol,
                                           err_msg="subgroup replica mismatch")
        return slabs[0]
    # hdim split: concatenate slabs in subgroup order
    return np.concatenate(slabs, axis=annot.hdim)


def apply_plan(st: ShardedTensor, plan: CommPlan,
               strict: bool = True) -> ShardedTensor:
    """Execute a communication plan stage by stage."""
    shape = st.shape
    state = dict(st.parts)
    annot = st.annot
    for stage in plan.stages:
        next_annot = stage.annot_after
        delivered: dict[int, list[tuple[Box, np.ndarray]]] = {}
        for step in stage.steps:
            for g in step.groups:
                contribs = []
                for s in g.srcs:
                    sbox = annot.device_box(s, shape)
                    if not box_contains(sbox, g.box):
                        raise AssertionError(
                            f"src dev {s} box {sbox} does not contain group box {g.box}")
                    contribs.append(state[s][rel_slices(sbox, g.box)])
                piece = sum(np.asarray(c, dtype=np.float64) for c in contribs) \
                    if g.reduce else contribs[0]
                for d in g.dsts:
                    delivered.setdefault(d, []).append((g.box, np.asarray(piece)))

        new_state: dict[int, np.ndarray] = {}
        for dev in next_annot.devices:
            box = next_annot.device_box(dev, shape)
            arr = np.zeros(box_shape(box), dtype=st.dtype)
            covered = np.zeros(box_shape(box), dtype=bool)
            # local retention first (identity / local-copy path) ...
            if dev in annot.devices:
                pbox = annot.device_box(dev, shape)
                inter = box_intersect(pbox, box)
                if inter is not None:
                    arr[rel_slices(box, inter)] = state[dev][rel_slices(pbox, inter)]
                    covered[rel_slices(box, inter)] = True
            # ... then deliveries override
            for dbox, piece in delivered.get(dev, ()):
                inter = box_intersect(dbox, box)
                if inter is None:
                    continue
                arr[rel_slices(box, inter)] = piece[rel_slices(dbox, inter)]
                covered[rel_slices(box, inter)] = True
            if strict and not covered.all():
                kinds = "+".join(st_.kind for st_ in stage.steps)
                raise AssertionError(
                    f"dev {dev}: {int((~covered).sum())} uncovered elements "
                    f"after stage [{kinds}]")
            new_state[dev] = arr.astype(st.dtype)
        state, annot = new_state, next_annot
    return ShardedTensor(shape, annot, state)


def roundtrip_check(value: np.ndarray, src: HSPMD, dst: HSPMD, plan: CommPlan,
                    rng: np.random.Generator | None = None,
                    atol: float = 1e-5) -> None:
    """scatter by src -> apply plan -> gather must reproduce ``value``
    under the dst annotation (the canonical property test)."""
    st = scatter(value, src, rng=rng)
    out = apply_plan(st, plan)
    assert out.annot is plan.annots[-1] or out.annot == plan.annots[-1]
    # every device must hold exactly its dst shard
    recon = gather(out, atol=atol)
    np.testing.assert_allclose(recon, value, atol=atol)
    for dev in dst.devices:
        box = dst.device_box(dev, value.shape)
        want = value[tuple(slice(lo, hi) for lo, hi in box)]
        deg = dst.partial_degree(dev)
        if deg == 1:
            np.testing.assert_allclose(out.parts[dev], want, atol=atol,
                                       err_msg=f"dev {dev} shard mismatch")
