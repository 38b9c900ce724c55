"""Communication plan IR produced by hierarchical resolution (paper §4).

A plan is an ordered list of *stages*; each stage is one :class:`CommStep`
(a set of independent device groups that would run concurrently on a real
cluster) together with the annotation that holds after the stage.

All geometry is expressed in *global* tensor coordinates so the simulator,
the JAX executor and the cost model share one language.

The unifying primitive is the :class:`SliceGroup`: a global box, the
devices contributing it (summands when ``reduce`` else identical copies)
and the devices that must hold it afterwards.  Every operator in the
paper's Fig 4 decision tree lowers onto it:

  kind        paper op                  group structure
  ---------   -----------------------   -------------------------------
  ``ID``      identity                  (no groups)
  ``SR``      send-receive              ({src} -> {dst}) per pair
  ``AR``      all-reduce                (G -> G, reduce) per box
  ``RS``      reduce-scatter            (G -> {g_i}, reduce) per sub-box
  ``AG``      all-gather                ({g_i} -> G) per owned piece
  ``SplitAR`` split-all-reduce          cross-subgroup fine-slice AR
  ``SplitRS`` split-reduce-scatter      cross-subgroup fine-slice reduce
  ``SplitAG`` split-all-gather          cross-subgroup fine-slice gather
  ``BSR``     batched-send-receive      ({chosen_src} -> {dst}) per slice

Keeping the paper's operator *names* in ``kind`` preserves the
classification (bottom-tier orange vs top-tier blue in Fig 4) for
reporting and cost modeling, while the executor stays uniform.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from .annotations import HSPMD

Box = tuple[tuple[int, int], ...]

BOTTOM_KINDS = ("ID", "SR", "AR", "RS", "AG")
TOP_KINDS = ("SplitAR", "SplitRS", "SplitAG")


def box_shape(box: Box) -> tuple[int, ...]:
    return tuple(hi - lo for lo, hi in box)


def box_numel(box: Box) -> int:
    n = 1
    for lo, hi in box:
        n *= hi - lo
    return n


def box_nbytes(box: Box, itemsize: int = 2) -> int:
    return box_numel(box) * itemsize


def box_intersect(a: Box, b: Box) -> Box | None:
    out = []
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def box_contains(outer: Box, inner: Box) -> bool:
    return all(olo <= ilo and ihi <= ohi
               for (olo, ohi), (ilo, ihi) in zip(outer, inner))


def rel_slices(outer: Box, inner: Box) -> tuple[slice, ...]:
    """Slices addressing ``inner`` within a local array laid out as ``outer``."""
    return tuple(slice(ilo - olo, ihi - olo)
                 for (olo, _), (ilo, ihi) in zip(outer, inner))


@dataclass(frozen=True)
class SliceGroup:
    box: Box
    srcs: tuple[int, ...]
    dsts: tuple[int, ...]
    reduce: bool = False


@dataclass(frozen=True)
class CommStep:
    kind: str
    groups: tuple[SliceGroup, ...]

    def nbytes_moved(self, itemsize: int = 2) -> int:
        """Bytes crossing device boundaries (copies to self are free)."""
        total = 0
        for g in self.groups:
            nb = box_nbytes(g.box, itemsize)
            if g.reduce:
                # ring cost proxy: every non-root contribution moves once,
                # plus fan-out to every dst that is not a src
                total += nb * (len(g.srcs) - 1)
                total += nb * len([d for d in g.dsts if d not in g.srcs])
            else:
                for d in g.dsts:
                    if d not in g.srcs:
                        total += nb
        return total


@dataclass(frozen=True)
class Stage:
    """Steps that run concurrently (they touch disjoint device groups),
    followed by the annotation that holds once the stage completes."""

    steps: tuple[CommStep, ...]
    annot_after: HSPMD


@dataclass
class CommPlan:
    """Resolution result: ordered stages + bookkeeping.

    Each stage may carry several parallel steps (e.g. subgroup 0 does an
    AR while subgroup 1 does an AG — paper Fig 9's CommOp id=2); the final
    stage's annotation always equals the requested destination.
    """

    src: HSPMD | None = None
    dst: HSPMD | None = None
    stages: list[Stage] = field(default_factory=list)
    kind: str = ""  # classification label, e.g. "bottom:AR", "top:SplitAG+RS"

    def add(self, steps: CommStep | Sequence[CommStep],
            annot_after: HSPMD) -> None:
        if isinstance(steps, CommStep):
            steps = (steps,)
        self.stages.append(Stage(tuple(steps), annot_after))

    @property
    def steps(self) -> list[CommStep]:
        return [s for st in self.stages for s in st.steps]

    @property
    def annots(self) -> list[HSPMD]:
        return [st.annot_after for st in self.stages]

    # -- statistics for benchmarks / the cost model ------------------------
    def message_count(self) -> int:
        n = 0
        for s in self.steps:
            for g in s.groups:
                if g.reduce or s.kind in ("AR", "RS", "AG", "SplitAR",
                                          "SplitRS", "SplitAG"):
                    n += 1  # one collective launch per group
                else:
                    n += len([d for d in g.dsts if d not in g.srcs])
        return n

    def nbytes_moved(self, itemsize: int = 2) -> int:
        return sum(s.nbytes_moved(itemsize) for s in self.steps)

    def per_device_send_bytes(self, itemsize: int = 2) -> dict[int, int]:
        """Point-to-point send volume attribution (BSR/SR steps only)."""
        vol: dict[int, int] = {}
        for s in self.steps:
            if s.kind not in ("BSR", "SR"):
                continue
            for g in s.groups:
                src = g.srcs[0]
                for d in g.dsts:
                    if d != src:
                        vol[src] = vol.get(src, 0) + box_nbytes(g.box, itemsize)
        return vol

    def describe(self) -> str:
        lines = [f"CommPlan<{self.kind}> ({len(self.steps)} stage(s))"]
        for i, s in enumerate(self.steps):
            lines.append(f"  stage {i}: {s.kind} x{len(s.groups)} groups, "
                         f"{s.nbytes_moved()} B moved")
        return "\n".join(lines)
