"""Hierarchical communication resolution (paper §4, Fig 4).

Given a (source, destination) :class:`HSPMD` annotation pair, derive a
:class:`CommPlan` that realizes the transformation, preferring collective
operators and falling back to batched-send-receive:

* **Bottom tier** (§4.1) — same HSize & HDim: every sharding subgroup
  resolves independently: Identity / SendRecv (DG change), AR / RS / AG
  (Partial->Dup, Partial->Split, Split->Dup), else BSR.
* **Top tier** (§4.2) — same HSize & DG Union, HDim differs:
  SplitAR / SplitRS / SplitAG over finest-grained slices; when the DS
  Union differs too, a bottom-tier alignment stage runs first (Fig 7).
* **Fallback** (§4.3) — BSR, which cannot move *Partial* tensors; such
  requests raise :class:`UnsupportedCommError` (paper's stated limit).

Groups are produced by a *fine-slice* builder that is exact for arbitrary
geometry (including bottom-tier splits along the HDim axis and non-uniform
``hsplits``); the paper's operator names are preserved in ``CommStep.kind``
for classification, statistics and cost modeling.

Gradient synchronization rides these same rules (reverse-mode autodiff,
``core.graph.backward``): parameter grads are deduced PARTIAL wherever
the forward consumed a replica, and the grad-reduce CommOp's
(Partial -> param annotation) pair resolves here to AR for replicated
params or RS over the DP dim for Split-sharded params — no
training-specific communication logic exists anywhere.
"""

from __future__ import annotations

from .annotations import DUP, PARTIAL, DS, HSPMD
from .bsr import PartialBsrError, plan_bsr
from .plan import (Box, CommPlan, CommStep, SliceGroup, box_intersect)
from .topology import Topology, UniformTopology


class UnsupportedCommError(ValueError):
    pass


def _annot_equal(a: HSPMD, b: HSPMD) -> bool:
    # exact placement equality: entry ORDER matters (it determines the
    # device -> shard coordinate decomposition)
    return (a.same_dg_union(b)
            and all(x.entries == y.entries for x, y in zip(a.dss, b.dss))
            and a.hdim == b.hdim and a.hsplits == b.hsplits)


def _summand_id(annot: HSPMD, dev: int) -> tuple[int, int]:
    """Identifies which additive summand a device's shard carries."""
    g = annot.subgroup_of(dev)
    ds = annot.dss[g]
    pos = annot.dgs[g].index(dev)
    pcoord = ds.coords(pos).get(PARTIAL, 0)
    top = g if annot.hdim == PARTIAL else -1
    return (top, pcoord)


def _bottom_pcoord(annot: HSPMD, dev: int) -> int:
    g = annot.subgroup_of(dev)
    pos = annot.dgs[g].index(dev)
    return annot.dss[g].coords(pos).get(PARTIAL, 0)


def _bottom_pdegree(annot: HSPMD, dev: int) -> int:
    g = annot.subgroup_of(dev)
    return annot.dss[g].get(PARTIAL)


def _fine_slice_groups(src: HSPMD, dst: HSPMD, shape: tuple[int, ...],
                       src_devs: tuple[int, ...], dst_devs: tuple[int, ...],
                       reduce: bool) -> tuple[SliceGroup, ...]:
    """Exact slice-group construction.

    For every receiver's destination box, refined against source shard
    boundaries: pick contributing sources (one representative per distinct
    summand when reducing, a single copy otherwise) and record the
    delivery.  Groups with identical (box, srcs) merge their dst lists.

    When the *destination* keeps a bottom-tier Partial degree (> 1), that
    partial coordinate is a **spectator**: a receiver with bottom partial
    coordinate ``p`` only accepts contributions from sources with the same
    ``p`` (a top-tier SplitAR/SplitRS/SplitAG reduces or gathers across
    subgroups, never across the surviving bottom-tier summands).
    """
    src_boxes = {d: src.device_box(d, shape) for d in src_devs}
    dst_boxes = {d: dst.device_box(d, shape) for d in dst_devs}

    cuts: list[list[int]] = []
    for dim in range(len(shape)):
        pts = set()
        for b in src_boxes.values():
            pts.update(b[dim])
        cuts.append(sorted(pts))

    acc: dict[tuple[Box, tuple[int, ...]], set[int]] = {}
    for recv, rbox in dst_boxes.items():
        dim_segs: list[list[tuple[int, int]]] = []
        for d, (lo, hi) in enumerate(rbox):
            pts = [lo] + [c for c in cuts[d] if lo < c < hi] + [hi]
            dim_segs.append(list(zip(pts[:-1], pts[1:])))

        recv_pdeg = _bottom_pdegree(dst, recv)
        recv_pc = _bottom_pcoord(dst, recv) if recv_pdeg > 1 else None

        def rec(d: int, prefix: list[tuple[int, int]]):
            if d == len(shape):
                cell = tuple(prefix)
                owners = [dev for dev, b in src_boxes.items()
                          if box_intersect(b, cell) == cell]
                if recv_pc is not None:
                    # spectator bottom-partial: only same-summand sources
                    owners = [o for o in owners
                              if _bottom_pcoord(src, o) == recv_pc]
                if not owners:
                    raise UnsupportedCommError(f"no source owner for {cell}")
                if reduce:
                    by_sid: dict[tuple[int, int], int] = {}
                    for dev in owners:
                        by_sid.setdefault(_summand_id(src, dev), dev)
                    srcs = tuple(sorted(by_sid.values()))
                else:
                    if recv in owners:
                        return  # heuristic (I): local copy, zero traffic
                    if any(_bottom_pdegree(src, o) > 1 for o in owners) \
                            and recv_pc is None:
                        raise UnsupportedCommError(
                            "copying Partial shards into a non-Partial "
                            "destination requires a reduction")
                    srcs = (min(owners),)
                acc.setdefault((cell, srcs), set()).add(recv)
                return
            for seg in dim_segs[d]:
                rec(d + 1, prefix + [seg])

        rec(0, [])
    return tuple(SliceGroup(box, srcs, tuple(sorted(dsts)), reduce)
                 for (box, srcs), dsts in sorted(acc.items()))


# ---------------------------------------------------------------------------
# bottom tier (§4.1)
# ---------------------------------------------------------------------------

def _sr_pairs(sds: DS, dds: DS, sdg, ddg) -> list[tuple[int, int]]:
    """Positional matching by shard *coordinates* (robust to DS entry-order
    permutations): returns (src_dev, dst_dev) pairs that differ."""
    src_by_coord = {tuple(sorted(sds.coords(p).items())): sdg[p]
                    for p in range(len(sdg))}
    pairs = []
    for q in range(len(ddg)):
        key = tuple(sorted(dds.coords(q).items()))
        s = src_by_coord[key]
        if s != ddg[q]:
            pairs.append((s, ddg[q]))
    return pairs


def _classify_bottom(sds: DS, dds: DS, sdg, ddg) -> str:
    """Paper Fig 4/5 bottom-tier classification for one subgroup."""
    if sds.same_sharding(dds):
        return "ID" if not _sr_pairs(sds, dds, sdg, ddg) else "SR"
    if sdg.devices != ddg.devices:
        return "BSR"
    sm, dm = dict(sds.entries), dict(dds.entries)
    sp, dp = sm.get(PARTIAL, 1), dm.get(PARTIAL, 1)
    sdup, ddup = sm.get(DUP, 1), dm.get(DUP, 1)
    s_splits = {d: n for d, n in sm.items() if d >= 0}
    d_splits = {d: n for d, n in dm.items() if d >= 0}
    if sp > 1 and dp == 1:
        if d_splits == s_splits and ddup == sdup * sp:
            return "AR"                      # Partial -> Duplicate
        grown = {d: n for d, n in d_splits.items()
                 if n != s_splits.get(d, 1)}
        if (ddup == sdup and len(grown) == 1):
            d, n = next(iter(grown.items()))
            if n == s_splits.get(d, 1) * sp and all(
                    d_splits.get(k, 1) == v for k, v in s_splits.items() if k != d):
                return "RS"                  # Partial -> Split(d)
    if sp == 1 and dp == 1:
        shrunk = {d: n for d, n in s_splits.items()
                  if d_splits.get(d, 1) < n and d_splits.get(d, 1) == 1}
        if len(shrunk) == 1:
            d, n = next(iter(shrunk.items()))
            if ddup == sdup * n and all(
                    d_splits.get(k, 1) == v for k, v in s_splits.items() if k != d):
                return "AG"                  # Split(d) -> Duplicate
    return "BSR"


def _bottom_plan(src: HSPMD, dst: HSPMD, shape, topology, itemsize) -> CommPlan:
    plan = CommPlan(src=src, dst=dst)
    kinds: dict[str, list[SliceGroup]] = {}
    labels = []
    for i in range(src.hsize):
        kind = _classify_bottom(src.dss[i], dst.dss[i], src.dgs[i], dst.dgs[i])
        labels.append(kind)
        if kind == "ID":
            continue
        if kind == "SR":
            groups = [
                SliceGroup(src.device_box(s, shape), (s,), (d,))
                for s, d in _sr_pairs(src.dss[i], dst.dss[i],
                                      src.dgs[i], dst.dgs[i])]
            kinds.setdefault("SR", []).extend(groups)
            continue
        if kind == "BSR" and (src.dss[i].has_partial or dst.dss[i].has_partial):
            raise UnsupportedCommError(
                f"subgroup {i}: Partial repartition not expressible as "
                f"collective and BSR cannot move Partial "
                f"({src.dss[i]} -> {dst.dss[i]})")
        reduce = src.dss[i].has_partial
        groups = _fine_slice_groups(
            src, dst, shape, src.dgs[i].devices, dst.dgs[i].devices, reduce)
        kinds.setdefault(kind, []).extend(groups)
    steps = [CommStep(kind, tuple(groups))
             for kind, groups in kinds.items() if groups]
    plan.add(steps or CommStep("ID", ()), dst)
    plan.kind = "bottom:" + "+".join(sorted(set(labels)))
    return plan


# ---------------------------------------------------------------------------
# top tier (§4.2)
# ---------------------------------------------------------------------------

def _classify_top(src: HSPMD, dst: HSPMD) -> str:
    if src.hdim == PARTIAL and dst.hdim == DUP:
        return "SplitAR"
    if src.hdim == PARTIAL and dst.hdim >= 0:
        return "SplitRS"
    if src.hdim >= 0 and dst.hdim == DUP:
        return "SplitAG"
    if src.hdim == DUP and dst.hdim >= 0:
        return "Slice"  # local slab extraction, zero communication
    return "BSR"


def _top_step(src: HSPMD, dst: HSPMD, shape, plan: CommPlan) -> str:
    kind = _classify_top(src, dst)
    if kind == "BSR":
        if src.has_partial or dst.has_partial:
            raise UnsupportedCommError(
                f"top-tier hdim {src.hdim}->{dst.hdim} with Partial")
        groups = _fine_slice_groups(src, dst, shape, src.devices,
                                    dst.devices, reduce=False)
        plan.add(CommStep("BSR", groups), dst)
        return kind
    if kind == "Slice":
        # zero-comm only when every device's dst box is inside its src box
        # (e.g. bottom tier doesn't split the hdim axis); otherwise shards
        # must move: fall back to BSR geometry.
        from .plan import box_contains
        contained = all(
            box_contains(src.device_box(d, shape), dst.device_box(d, shape))
            for d in dst.devices)
        if contained:
            plan.add(CommStep("Slice", ()), dst)
            return kind
        if src.has_partial or dst.has_partial:
            raise UnsupportedCommError(
                "hdim Dup->Split with Partial shards requires data movement "
                "that BSR cannot express")
        groups = _fine_slice_groups(src, dst, shape, src.devices,
                                    dst.devices, reduce=False)
        plan.add(CommStep("BSR", groups), dst)
        return "BSR"
    reduce = src.hdim == PARTIAL
    groups = _fine_slice_groups(src, dst, shape, src.devices, dst.devices,
                                reduce)
    plan.add(CommStep(kind, groups), dst)
    return kind


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def resolve(src: HSPMD, dst: HSPMD, shape: tuple[int, ...],
            topology: Topology | None = None, itemsize: int = 2) -> CommPlan:
    """Derive a communication plan transforming ``src`` into ``dst``."""
    topology = topology or UniformTopology()
    if _annot_equal(src, dst):
        plan = CommPlan(src=src, dst=dst, kind="identity")
        plan.add(CommStep("ID", ()), dst)
        return plan

    same_top = (src.hsize == dst.hsize and src.hdim == dst.hdim
                and src.hsplits == dst.hsplits)
    if same_top:
        return _bottom_plan(src, dst, shape, topology, itemsize)

    if src.hsize == dst.hsize and src.same_dg_union(dst):
        plan = CommPlan(src=src, dst=dst)
        if src.same_ds_union(dst):
            kind = _top_step(src, dst, shape, plan)
            plan.kind = f"top:{kind}"
            return plan
        # Fig 7: bottom-tier DS alignment first, then the top-tier op
        mid = HSPMD(src.dgs, dst.dss, src.hdim, src.hsplits)
        bottom = _bottom_plan(src, mid, shape, topology, itemsize)
        for stage in bottom.stages:
            real = [s for s in stage.steps if s.kind != "ID"]
            if real:
                plan.add(real, stage.annot_after)
        kind = _top_step(mid, dst, shape, plan)
        plan.kind = f"{bottom.kind}>top:{kind}"
        return plan

    # DG Unions differ or HSize differs -> BSR fallback (§4.3)
    if src.has_partial or dst.has_partial:
        raise UnsupportedCommError(
            "cross-union repartition of Partial tensors is unsupported "
            "(paper §4.3 Discussions)")
    bplan = plan_bsr(src, dst, shape, topology, itemsize=itemsize)
    plan = CommPlan(src=src, dst=dst, kind="fallback:BSR")
    plan.add(bplan.to_step(), dst)
    return plan
