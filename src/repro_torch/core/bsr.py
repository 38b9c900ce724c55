"""Batched-send-receive (BSR) planning (paper §4.3, Fig 8) and the fused
multi-tensor variant used by dynamic graph switching (paper §6.2, Fig 12).

The planner builds a *BSR table* mapping every finest-grained slice to its
owner devices and the devices that need it, then picks a sender per
(slice, receiver) with the paper's three heuristics:

  (I)   local copy when the receiver already owns the slice,
  (II)  prefer the highest-bandwidth owner->receiver link,
  (III) tie-break on the lowest cumulative send load.

``plan_bsr_naive`` omits (II)/(III) and fusion — the paper's Fig 18 / Table 2
baseline ("Unfused BSR w/o Heuristics", minimal rank id sends).

Fusion (``fuse``): transfers between the same (src, dst) pair — across *all*
tensors of a switch — are coalesced into one message to amortize launch
latency; the fused plan also shares one global cumulative-load state so
heuristic (III) balances the whole transition, not each tensor separately.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .annotations import HSPMD
from .plan import (Box, CommStep, SliceGroup, box_intersect, box_nbytes)
from .topology import Topology, UniformTopology


class PartialBsrError(ValueError):
    """BSR cannot move *Partial* tensors (paper §4.3 Discussions)."""


@dataclass
class BsrEntry:
    """One row of the BSR table: a fine slice, who owns it, who needs it."""

    box: Box
    owners: tuple[int, ...]
    needers: tuple[int, ...]
    tensor: str = ""
    itemsize: int = 2


@dataclass
class BsrAssignment:
    src: int
    dst: int
    box: Box
    tensor: str = ""
    itemsize: int = 2
    local: bool = False

    @property
    def nbytes(self) -> int:
        return box_nbytes(self.box, self.itemsize)


@dataclass
class BsrPlan:
    assignments: list[BsrAssignment] = field(default_factory=list)
    fused: bool = True

    # -- statistics (paper Table 2 / Fig 18) -------------------------------
    def transfers(self) -> list[BsrAssignment]:
        return [a for a in self.assignments if not a.local]

    def local_copies(self) -> list[BsrAssignment]:
        return [a for a in self.assignments if a.local]

    def message_count(self) -> int:
        """Messages after (optional) per-pair fusion."""
        xs = self.transfers()
        if not self.fused:
            return len(xs)
        return len({(a.src, a.dst) for a in xs})

    def total_bytes(self) -> int:
        return sum(a.nbytes for a in self.transfers())

    def per_sender_bytes(self, topology: Topology | None = None,
                         fast_threshold: float | None = None
                         ) -> dict[int, tuple[int, int]]:
        """Per-sender (fast-link bytes, slow-link bytes) — the Table 2 shape.

        A link is "fast" when its bandwidth exceeds ``fast_threshold``
        (defaults to the mean of observed link bandwidths).
        """
        topology = topology or UniformTopology()
        bands = {(a.src, a.dst): topology.bandwidth(a.src, a.dst)
                 for a in self.transfers()}
        if fast_threshold is None:
            fast_threshold = (sum(bands.values()) / len(bands)) if bands else 0.0
        out: dict[int, tuple[int, int]] = {}
        for a in self.transfers():
            fast, slow = out.get(a.src, (0, 0))
            if bands[(a.src, a.dst)] >= fast_threshold:
                fast += a.nbytes
            else:
                slow += a.nbytes
            out[a.src] = (fast, slow)
        return out

    def est_time(self, topology: Topology | None = None,
                 launch_us: float = 10.0) -> float:
        """Completion-time proxy: max over senders of serialized send time,
        plus per-message launch latency."""
        topology = topology or UniformTopology()
        per_sender: dict[int, float] = {}
        for a in self.transfers():
            per_sender[a.src] = per_sender.get(a.src, 0.0) + \
                topology.time_for(a.src, a.dst, a.nbytes)
        t = max(per_sender.values(), default=0.0)
        return t + self.message_count() * launch_us * 1e-6

    def to_step(self) -> CommStep:
        groups = tuple(
            SliceGroup(a.box, (a.src,), (a.dst,), reduce=False)
            for a in self.transfers())
        return CommStep("BSR", groups)


# ---------------------------------------------------------------------------
# table construction
# ---------------------------------------------------------------------------

def _cuts(boxes: list[Box], ndim: int) -> list[list[int]]:
    cuts = [set() for _ in range(ndim)]
    for b in boxes:
        for d, (lo, hi) in enumerate(b):
            cuts[d].add(lo)
            cuts[d].add(hi)
    return [sorted(c) for c in cuts]


def build_table(src: HSPMD, dst: HSPMD, shape: tuple[int, ...],
                tensor: str = "", itemsize: int = 2) -> list[BsrEntry]:
    """Finest-grained slice table (paper Fig 8, left)."""
    if src.has_partial or dst.has_partial:
        raise PartialBsrError(
            f"BSR cannot repartition Partial tensors (tensor={tensor!r})")
    src_boxes = {d: src.device_box(d, shape) for d in src.devices}
    dst_boxes = {d: dst.device_box(d, shape) for d in dst.devices}

    entries: list[BsrEntry] = []
    # Fine slices are generated per *receiver* box, refined against source
    # cuts only — this keeps the table linear in receivers for the common
    # aligned cases while remaining exact.
    cut_lists = _cuts(list(src_boxes.values()), len(shape))
    for recv, rbox in dst_boxes.items():
        # refine rbox by source cuts
        dim_segs: list[list[tuple[int, int]]] = []
        for d, (lo, hi) in enumerate(rbox):
            pts = [lo] + [c for c in cut_lists[d] if lo < c < hi] + [hi]
            dim_segs.append(list(zip(pts[:-1], pts[1:])))
        # enumerate cells
        def rec(d: int, prefix: list[tuple[int, int]]):
            if d == len(shape):
                cell = tuple(prefix)
                owners = tuple(dev for dev, b in src_boxes.items()
                               if box_intersect(b, cell) == cell)
                if not owners:
                    raise AssertionError(f"no owner for slice {cell}")
                entries.append(BsrEntry(cell, owners, (recv,), tensor, itemsize))
                return
            for seg in dim_segs[d]:
                rec(d + 1, prefix + [seg])
        rec(0, [])
    # merge needers of identical (box, owners, tensor) rows
    merged: dict[tuple, BsrEntry] = {}
    for e in entries:
        key = (e.box, e.owners, e.tensor)
        if key in merged:
            m = merged[key]
            m.needers = tuple(sorted(set(m.needers) | set(e.needers)))
        else:
            merged[key] = dataclasses.replace(e)
    return list(merged.values())


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def _plan(entries: list[BsrEntry], topology: Topology,
          use_heuristics: bool, send_load: dict[int, int]) -> list[BsrAssignment]:
    out: list[BsrAssignment] = []
    for e in entries:
        for recv in e.needers:
            # heuristic (I): local copy
            if recv in e.owners:
                out.append(BsrAssignment(recv, recv, e.box, e.tensor,
                                         e.itemsize, local=True))
                continue
            if use_heuristics:
                # (II) highest bandwidth, (III) lowest cumulative send load
                sender = min(
                    e.owners,
                    key=lambda s: (-topology.bandwidth(s, recv),
                                   send_load.get(s, 0), s))
            else:
                sender = min(e.owners)  # minimal rank id (paper baseline)
            a = BsrAssignment(sender, recv, e.box, e.tensor, e.itemsize)
            send_load[sender] = send_load.get(sender, 0) + a.nbytes
            out.append(a)
    return out


def plan_bsr(src: HSPMD, dst: HSPMD, shape: tuple[int, ...],
             topology: Topology | None = None, tensor: str = "",
             itemsize: int = 2) -> BsrPlan:
    """Single-tensor BSR with heuristics + per-pair fusion."""
    topology = topology or UniformTopology()
    entries = build_table(src, dst, shape, tensor, itemsize)
    return BsrPlan(_plan(entries, topology, True, {}), fused=True)


def plan_bsr_naive(src: HSPMD, dst: HSPMD, shape: tuple[int, ...],
                   tensor: str = "", itemsize: int = 2) -> BsrPlan:
    """Paper baseline: min-rank-id senders, no fusion."""
    entries = build_table(src, dst, shape, tensor, itemsize)
    return BsrPlan(_plan(entries, UniformTopology(), False, {}), fused=False)


def plan_fused_bsr(tensors: list[tuple[str, HSPMD, HSPMD, tuple[int, ...], int]],
                   topology: Topology | None = None) -> BsrPlan:
    """Fused multi-tensor BSR (paper §6.2): one global table, one shared
    cumulative-load state, per-pair message fusion across tensors.

    ``tensors``: (name, src annot, dst annot, global shape, itemsize).
    """
    topology = topology or UniformTopology()
    entries: list[BsrEntry] = []
    for name, src, dst, shape, itemsize in tensors:
        entries.extend(build_table(src, dst, shape, name, itemsize))
    send_load: dict[int, int] = {}
    return BsrPlan(_plan(entries, topology, True, send_load), fused=True)


def plan_unfused_bsr(tensors: list[tuple[str, HSPMD, HSPMD, tuple[int, ...], int]],
                     topology: Topology | None = None) -> BsrPlan:
    """Per-tensor planning (heuristics on, but load state and fusion do not
    span tensors) — the paper's middle baseline in Fig 18."""
    topology = topology or UniformTopology()
    out: list[BsrAssignment] = []
    for name, src, dst, shape, itemsize in tensors:
        entries = build_table(src, dst, shape, name, itemsize)
        out.extend(_plan(entries, topology, True, {}))
    return BsrPlan(out, fused=False)
