"""Lower a :class:`~repro_torch.core.plan.CommPlan` onto stacked torch rows.

The port of ``repro/runtime/lowering.py``.  The reference compiles a
plan's stages into one ``jax.shard_map`` program over a device mesh; here
every virtual device is one row of a stacked ``(mesh, *pad)`` buffer on a
single torch device (one GPU, or the CPU), so a virtual mesh of 2, 4 or 8
devices runs on one card:

* copy groups (SR / AG / SplitAG / BSR): the (src, dst) pairs of a stage
  are fused into rounds (each source and each destination at most once a
  round, as the reference fuses them into batched permutes); a round
  whose sources all hand over the same relative slice is one row gather,
* reduce groups (AR / RS / SplitAR / SplitRS): a float64 left fold in
  the group's ``srcs`` order, cast back — bit for bit what
  ``simulator.apply_plan`` does,
* ID / Slice: the local-retention path.

Stages that play the identical role on every row (a uniform reduce, a
uniform re-slice, a uniform all-gather; the reference's switch-free
paths) run as a handful of whole-buffer ops: one row gather per group
partition for a reduce, one strided gather for a re-slice, one gather per
tile for an all-gather.  Everything else takes the general path: the
rounds' row gathers, then each destination row's box assembled from local
retention and deliveries, in the simulator's order (later deliveries
override earlier ones).

Geometry (boxes, rounds, coverage) is computed and checked when the plan
is lowered; :meth:`PlanLowering.apply` only moves data.  The float64 fold
is native on both the GPU and the CPU, so the reference's x64 scope
(``maybe_x64``) has no counterpart.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.annotations import HSPMD
from repro_torch.core.plan import (Box, CommPlan, box_contains,
                                   box_intersect, box_shape, rel_slices)
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DeviceOrder:
    """Mapping between logical HSPMD device ids and stacked-row positions."""

    devices: tuple[int, ...]

    @classmethod
    def for_plan(cls, plan: CommPlan) -> "DeviceOrder":
        devs = set()
        if plan.src is not None:
            devs |= set(plan.src.devices)
        for annot in plan.annots:
            devs |= set(annot.devices)
        for step in plan.steps:
            for g in step.groups:
                devs |= set(g.srcs) | set(g.dsts)
        return cls(tuple(sorted(devs)))

    def pos(self, dev: int) -> int:
        return self.devices.index(dev)

    def __len__(self) -> int:
        return len(self.devices)


@dataclass
class LoweringStats:
    """Static accounting of a lowered plan or graph, plus the kernel
    dispatch tally of the compute seam (``runtime.program``): how many
    attention classes go to the Hopper flash kernel (B1) and how many to
    the plain version (``kernels.policy``).  ``kernel_dispatches`` is the
    counterpart of the reference's ``pallas_dispatches``."""

    copy_pairs: int = 0        # point-to-point (src, dst) deliveries
    permute_rounds: int = 0    # fused rounds (the reference's ppermutes)
    gather_rounds: int = 0     # of which run as one row gather
    reduce_groups: int = 0     # reduce groups on the general path
    uniform_reduce_stages: int = 0  # stages run as whole-buffer reduces
    uniform_copy_stages: int = 0    # re-slice / all-gather whole-buffer
    stages: int = 0
    ref_dispatches: int = 0     # attention classes on the plain version
    kernel_dispatches: int = 0  # attention classes on the Hopper kernel
    # specialization-class accounting (core.lowered_ir):
    compute_segments: int = 0       # live compute segments
    straightline_segments: int = 0  # of which one class over every row
    class_runs: int = 0             # class executions over all segments
    # the rank path (``runtime.dist_lowering``), accumulated over its
    # runs, this rank's share:
    p2p_messages: int = 0   # point-to-point messages sent
    p2p_bytes: int = 0      # their bytes
    collectives: int = 0    # subgroup / world collectives joined
    staged_bytes: int = 0   # bytes copied between the device and the host

    def merge(self, other: "LoweringStats") -> None:
        for name in self.__dataclass_fields__:
            setattr(self, name, getattr(self, name) + getattr(other, name))


def pack_shards(parts, annot: HSPMD, shape: tuple[int, ...], n_mesh: int,
                order: DeviceOrder, out: "np.ndarray | None" = None
                ) -> np.ndarray:
    """Stack per-device shards into the runtime's ``(n_mesh, *pad)``
    buffer (each device's box zero-padded at the origin), validating
    every shard's shape against the annotation and promoting dtypes.

    ``out`` may pass a buffer from a PREVIOUS pack of the same tensor
    to fill in place (skips the zeroed allocation; the padding region
    is never written, so it stays zero from the first pack).  It is
    used only when its shape and dtype still match."""
    dtype = None
    for dev in annot.devices:
        arr = np.asarray(parts[dev])
        want = annot.device_shape(dev, shape)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(
                f"dev {dev}: shard shape {arr.shape} != {want} "
                f"expected by the annotation")
        dtype = arr.dtype if dtype is None else \
            np.promote_types(dtype, arr.dtype)
    full = (n_mesh,) + pad_shape(annot, shape)
    if out is not None and out.shape == full and out.dtype == dtype:
        stacked = out
    else:
        stacked = np.zeros(full, dtype=dtype)
    for dev in annot.devices:
        arr = np.asarray(parts[dev])
        stacked[(order.pos(dev),)
                + tuple(slice(0, s) for s in arr.shape)] = arr
    return stacked


def pad_shape(annot: HSPMD, shape: tuple[int, ...]) -> tuple[int, ...]:
    """Elementwise max of the per-device box shapes (uniform local buffer)."""
    dims = [1] * len(shape)
    for dev in annot.devices:
        for d, s in enumerate(annot.device_shape(dev, shape)):
            dims[d] = max(dims[d], s)
    return tuple(dims)


def check_stage_coverage(prev: HSPMD, nxt: HSPMD,
                         deliveries: list[tuple[Box, tuple[int, ...]]],
                         shape: tuple[int, ...], kinds: str) -> None:
    """Static replica of the simulator's strict coverage assertion."""
    for dev in nxt.devices:
        box = nxt.device_box(dev, shape)
        covered = np.zeros(box_shape(box), dtype=bool)
        if dev in prev.devices:
            inter = box_intersect(prev.device_box(dev, shape), box)
            if inter is not None:
                covered[rel_slices(box, inter)] = True
        for dbox, dsts in deliveries:
            if dev not in dsts:
                continue
            inter = box_intersect(dbox, box)
            if inter is not None:
                covered[rel_slices(box, inter)] = True
        if not covered.all():
            raise AssertionError(
                f"dev {dev}: {int((~covered).sum())} uncovered elements "
                f"after stage [{kinds}]")


@dataclass
class _Round:
    """One fused round: (src, dst) pairs with distinct srcs and dsts."""

    pairs: list[tuple[int, int, object]] = field(default_factory=list)
    srcs: set[int] = field(default_factory=set)
    dsts: set[int] = field(default_factory=set)
    #: (source rows, relative slice) when the round is one row gather
    gather: "tuple | None" = None

    def add(self, s: int, d: int, g) -> None:
        self.pairs.append((s, d, g))
        self.srcs.add(s)
        self.dsts.add(d)


def _fuse_rounds(pairs: list[tuple[int, int, object]]) -> list[_Round]:
    """Greedy round construction: each round uses every source and every
    destination at most once (ppermute's partial-permutation contract)."""
    rounds: list[_Round] = []
    for s, d, g in pairs:
        for r in rounds:
            if s not in r.srcs and d not in r.dsts:
                r.add(s, d, g)
                break
        else:
            r = _Round()
            r.add(s, d, g)
            rounds.append(r)
    return rounds


def _box_index(starts, shape, device) -> tuple[torch.Tensor, ...]:
    """Index tensors picking box ``starts[r] + [0, shape)`` out of row
    ``r`` of a stacked buffer: ``x[_box_index(...)]`` is ``(R, *shape)``
    in one gather."""
    n, rank = len(starts), len(shape)
    st = torch.as_tensor(np.asarray(starts, np.int64).reshape(n, rank),
                         device=device)
    idx = [torch.arange(n, device=device).view((n,) + (1,) * rank)]
    for d in range(rank):
        view = [1] * (rank + 1)
        view[0] = n
        off = st[:, d].view(view)
        view = [1] * (rank + 1)
        view[d + 1] = shape[d]
        idx.append(off + torch.arange(shape[d], device=device).view(view))
    return tuple(idx)


def _fold(contribs: list[torch.Tensor]) -> torch.Tensor:
    """Sum of one reduce group's contributions: a float64 left fold in
    ``srcs`` order."""
    acc = contribs[0].to(torch.float64)
    for c in contribs[1:]:
        acc = acc + c.to(torch.float64)
    return acc


class PlanLowering:
    """Applies one CommPlan's stages to a stacked ``(n_mesh, *pad)``
    buffer on one torch device (row ``order.pos(dev)`` holds device
    ``dev``'s local shard at the origin).

    All geometry (boxes, rounds, coverage, the whole-buffer fast paths'
    index tables) is computed and checked at construction;
    :meth:`apply` only moves data."""

    def __init__(self, plan: CommPlan, shape: tuple[int, ...],
                 order: DeviceOrder, device):
        if plan.src is None:
            raise ValueError("plan has no source annotation")
        self.plan = plan
        self.shape = tuple(shape)
        self.order = order
        self.n_mesh = len(order)
        self.device = torch.device(device)
        self.stats = LoweringStats()
        # a reducing plan (AR / RS / SplitAR / SplitRS groups) rather than
        # one that only copies
        self.has_reduce = any(g.reduce for s in plan.steps for g in s.groups)

        self._stage_rounds: list[list[_Round]] = []
        self._uniform_stages: list[dict | None] = []
        prev = plan.src
        for stage in plan.stages:
            uni = (self._uniform_stage_static(stage, prev)
                   or self._uniform_ident_static(stage, prev)
                   or self._uniform_gather_static(stage, prev))
            self._uniform_stages.append(uni)
            if uni is not None:
                if uni["kind"] == "reduce":
                    self.stats.uniform_reduce_stages += 1
                else:
                    self.stats.uniform_copy_stages += 1
            deliveries = [(g.box, g.dsts) for step in stage.steps
                          for g in step.groups]
            pairs = []
            for step in stage.steps:
                for g in step.groups:
                    for s in g.srcs:
                        sbox = prev.device_box(s, self.shape)
                        if not box_contains(sbox, g.box):
                            raise AssertionError(
                                f"src dev {s} box {sbox} does not contain "
                                f"group box {g.box}")
                    if g.reduce:
                        if uni is None:
                            self.stats.reduce_groups += 1
                        continue
                    src = g.srcs[0]
                    for d in g.dsts:
                        if d != src:
                            pairs.append((src, d, g))
            kinds = "+".join(st.kind for st in stage.steps)
            check_stage_coverage(prev, stage.annot_after, deliveries,
                                 self.shape, kinds)
            rounds = _fuse_rounds(pairs)
            if uni is None:    # uniform stages never run the rounds
                rounds = [self._round_static(r, prev) for r in rounds]
                self.stats.copy_pairs += len(pairs)
                self.stats.permute_rounds += len(rounds)
                self.stats.gather_rounds += sum(
                    r.gather is not None for r in rounds)
            self._stage_rounds.append(rounds)
            self.stats.stages += 1
            prev = stage.annot_after

    # -- static geometry -----------------------------------------------------

    def _round_static(self, r: _Round, prev) -> _Round:
        """Attach the round's one-gather form when every pair hands over
        the same relative slice of its source row."""
        rels = {rel_slices(prev.device_box(s, self.shape), g.box)
                for s, _, g in r.pairs}
        if len(rels) == 1:
            rows = torch.as_tensor([self.order.pos(s) for s, _, _ in r.pairs],
                                   device=self.device)
            r.gather = (rows, rels.pop())
        return r

    def _uniform_stage_static(self, stage, prev) -> dict | None:
        """Static descriptor of a *uniform reduce stage* — the symmetric
        case where every row plays the identical role:

        * every group is a reduce whose destinations equal its sources,
        * the groups' source positions partition the rows into
          equal-size subgroups,
        * every source extracts the same slice of its local padded
          buffer,
        * every destination's next-annotation box is fully covered by
          its group's box, at the same local offsets.

        Returns ``None`` when any condition fails (the general path)."""
        groups = [g for step in stage.steps for g in step.groups]
        if not groups or not all(g.reduce for g in groups):
            return None
        if any(set(g.dsts) != set(g.srcs) for g in groups):
            return None
        k = len(groups[0].srcs)
        if any(len(g.srcs) != k for g in groups):
            return None
        pos_groups = [[self.order.pos(s) for s in g.srcs] for g in groups]
        flat = sorted(p for ps in pos_groups for p in ps)
        if flat != list(range(self.n_mesh)):
            return None
        gshape = box_shape(groups[0].box)
        src_rel = None
        for g in groups:
            if box_shape(g.box) != gshape:
                return None
            for s in g.srcs:
                r = rel_slices(prev.device_box(s, self.shape), g.box)
                if src_rel is None:
                    src_rel = r
                elif r != src_rel:
                    return None
        nxt = stage.annot_after
        if set(nxt.devices) != set(self.order.devices):
            return None
        dst_rel = piece_rel = nbox_shape = None
        for g in groups:
            for dev in g.dsts:
                nbox = nxt.device_box(dev, self.shape)
                inter = box_intersect(g.box, nbox)
                if inter != nbox:   # piece must fully cover the dst box
                    return None
                d_r = rel_slices(nbox, inter)
                p_r = rel_slices(g.box, inter)
                bs = box_shape(nbox)
                if dst_rel is None:
                    dst_rel, piece_rel, nbox_shape = d_r, p_r, bs
                elif (d_r, p_r, bs) != (dst_rel, piece_rel, nbox_shape):
                    return None
        group_of = [0] * self.n_mesh
        for gi, ps in enumerate(pos_groups):
            for p in ps:
                group_of[p] = gi
        return {"kind": "reduce", "src_rel": src_rel, "k": k,
                "members": torch.as_tensor(pos_groups, device=self.device),
                "group_of": torch.as_tensor(group_of, device=self.device),
                "dst_rel": dst_rel, "piece_rel": piece_rel,
                "next_pad": pad_shape(nxt, self.shape)}

    @staticmethod
    def _has_partial(annot) -> bool:
        from repro_torch.core.annotations import PARTIAL
        return annot.hdim == PARTIAL or \
            any(ds.has_partial for ds in annot.dss)

    def _uniform_ident_static(self, stage, prev) -> dict | None:
        """Static descriptor of a *uniform identity stage* — no
        deliveries at all: every device re-slices data it already
        holds, with the same local output shape everywhere.  Only the
        slice OFFSETS vary per row (DP slab selection, TP column
        selection), so the stage is one strided gather.  Excludes
        Partial layouts: a Partial shard is a summand, and re-slicing
        summands is only meaningful through a reduce stage."""
        if any(step.groups for step in stage.steps):
            return None
        nxt = stage.annot_after
        if set(nxt.devices) != set(self.order.devices):
            return None
        if not set(self.order.devices) <= set(prev.devices):
            return None
        if self._has_partial(prev) or self._has_partial(nxt):
            return None
        out_shape = None
        starts: list = [None] * self.n_mesh
        for dev in self.order.devices:
            pbox = prev.device_box(dev, self.shape)
            nbox = nxt.device_box(dev, self.shape)
            if box_intersect(pbox, nbox) != nbox:
                return None      # output not locally available
            bs = box_shape(nbox)
            if out_shape is None:
                out_shape = bs
            elif bs != out_shape:
                return None
            r = rel_slices(pbox, nbox)
            starts[self.order.pos(dev)] = tuple(s.start for s in r)
        if out_shape != pad_shape(nxt, self.shape):
            return None
        noop = all(not any(s) for s in starts)
        return {"kind": "ident", "noop": noop, "out_shape": out_shape,
                "index": None if noop else _box_index(starts, out_shape,
                                                      self.device)}

    def _uniform_gather_static(self, stage, prev) -> dict | None:
        """Static descriptor of a *uniform gather stage*: pure copy
        deliveries where every device contributes its (identical-shape)
        local shard and assembles its next box from ``k`` such pieces
        at identical destination offsets — only WHICH rows supply the
        pieces differs, so each tile is one row gather.  Copies are
        exact; sources with overlapping boxes are interchangeable because
        replicated shards are bitwise identical (Partial layouts, whose
        shards are summands, are excluded)."""
        groups = [g for step in stage.steps for g in step.groups]
        if not groups or any(g.reduce for g in groups):
            return None
        nxt = stage.annot_after
        if set(nxt.devices) != set(self.order.devices):
            return None
        if set(prev.devices) != set(self.order.devices):
            return None
        if self._has_partial(prev) or self._has_partial(nxt):
            return None
        pboxes = [prev.device_box(self.order.devices[p], self.shape)
                  for p in range(self.n_mesh)]
        piece_shape = box_shape(pboxes[0])
        if any(box_shape(b) != piece_shape for b in pboxes):
            return None
        if piece_shape != pad_shape(prev, self.shape):
            return None
        next_pad = pad_shape(nxt, self.shape)
        template: list | None = None   # (dst_rel, piece_rel, shape) per tile
        picks: list = [None] * self.n_mesh
        for dev in self.order.devices:
            nbox = nxt.device_box(dev, self.shape)
            if box_shape(nbox) != next_pad:
                return None
            tiles, seen = [], set()
            for p in range(self.n_mesh):
                ib = box_intersect(pboxes[p], nbox)
                if ib is not None and ib not in seen:
                    seen.add(ib)
                    tiles.append(ib)
            tiles.sort(key=lambda b: tuple(lo for lo, _ in b))
            if sum(int(np.prod(box_shape(t))) for t in tiles) != \
                    int(np.prod(next_pad)):
                return None      # tiles must cover the dst box exactly...
            for a in range(len(tiles)):
                for b in range(a + 1, len(tiles)):
                    if box_intersect(tiles[a], tiles[b]) is not None:
                        return None   # ...without overlap
            if template is None:
                template = []
                for t in tiles:
                    p = next((p for p in range(self.n_mesh)
                              if box_contains(pboxes[p], t)), None)
                    if p is None:
                        return None
                    template.append((rel_slices(nbox, t),
                                     rel_slices(pboxes[p], t),
                                     box_shape(t)))
            if len(tiles) != len(template):
                return None
            chosen = []
            for t, (d_r, p_r, ts) in zip(tiles, template):
                if rel_slices(nbox, t) != d_r or box_shape(t) != ts:
                    return None
                p = next((p for p in range(self.n_mesh)
                          if box_contains(pboxes[p], t)
                          and rel_slices(pboxes[p], t) == p_r), None)
                if p is None:
                    return None
                chosen.append(p)
            picks[self.order.pos(dev)] = chosen
        return {"kind": "gather",
                "tiles": [(torch.as_tensor([picks[p][t]
                                            for p in range(self.n_mesh)],
                                           device=self.device),
                           template[t][1], template[t][0])
                          for t in range(len(template))],
                "next_pad": next_pad}

    # -- execution -----------------------------------------------------------

    def _run_uniform(self, x, uni, out_dtype):
        """Whole-buffer run of a uniform stage."""
        n = self.n_mesh
        if uni["kind"] == "ident":
            if uni["noop"] and tuple(x.shape[1:]) == uni["out_shape"]:
                return x.to(out_dtype)
            if uni["noop"]:
                return x[(slice(None),) + tuple(
                    slice(0, s) for s in uni["out_shape"])].to(out_dtype)
            return x[uni["index"]].to(out_dtype)
        out = torch.zeros((n,) + uni["next_pad"], dtype=out_dtype,
                          device=x.device)
        if uni["kind"] == "gather":
            for rows, piece_rel, dst_rel in uni["tiles"]:
                out[(slice(None),) + dst_rel] = x[(rows,) + piece_rel]
            return out
        contrib = x[(slice(None),) + uni["src_rel"]]
        c = contrib[uni["members"]]                 # (groups, k, *box)
        k = uni["k"]
        if k == 1:
            y = c[:, 0]
        elif k == 2 and c.dtype == out_dtype:
            # two operands: float64 holds more than twice the bits of
            # float32 and narrower types, so the float64 sum rounded back
            # IS the native sum (double rounding is harmless for one add)
            y = c[:, 0] + c[:, 1]
        else:
            y = _fold([c[:, j] for j in range(k)])
        out[(slice(None),) + uni["dst_rel"]] = \
            y[(uni["group_of"],) + uni["piece_rel"]]
        return out

    def _run_general(self, x, stage, rounds, prev, out_dtype):
        """Rounds' row gathers, reduce folds, then each destination row
        assembled from local retention and deliveries (in the simulator's
        order: deliveries override retention and earlier deliveries)."""
        received: dict[tuple[int, int], torch.Tensor] = {}
        for r in rounds:
            if r.gather is not None:
                rows, rel = r.gather
                got = x[(rows,) + rel]
                for j, (_, d, g) in enumerate(r.pairs):
                    received[(d, id(g))] = got[j]
                continue
            for s, d, g in r.pairs:
                received[(d, id(g))] = x[self.order.pos(s)][
                    rel_slices(prev.device_box(s, self.shape), g.box)]
        pieces = []
        for step in stage.steps:
            for g in step.groups:
                if g.reduce:
                    piece = _fold(
                        [x[self.order.pos(s)][rel_slices(
                            prev.device_box(s, self.shape), g.box)]
                         for s in g.srcs])
                    per_dst = {d: piece for d in g.dsts}
                else:
                    src = g.srcs[0]
                    own = x[self.order.pos(src)][rel_slices(
                        prev.device_box(src, self.shape), g.box)]
                    per_dst = {d: own if d == src else received[(d, id(g))]
                               for d in g.dsts}
                pieces.append((g.box, per_dst))
        nxt = stage.annot_after
        out = torch.zeros((self.n_mesh,) + pad_shape(nxt, self.shape),
                          dtype=out_dtype, device=x.device)
        for dev in nxt.devices:
            p = self.order.pos(dev)
            nbox = nxt.device_box(dev, self.shape)
            if dev in prev.devices:
                pbox = prev.device_box(dev, self.shape)
                inter = box_intersect(pbox, nbox)
                if inter is not None:
                    out[p][rel_slices(nbox, inter)] = \
                        x[p][rel_slices(pbox, inter)]
            for dbox, per_dst in pieces:
                piece = per_dst.get(dev)
                if piece is None:
                    continue
                inter = box_intersect(dbox, nbox)
                if inter is None:
                    continue
                out[p][rel_slices(nbox, inter)] = \
                    piece[rel_slices(dbox, inter)]
        return out

    def apply(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        """Run the plan's stages on the stacked buffer ``x``; returns the
        stacked buffer under the plan's last annotation."""
        out_dtype = out_dtype or x.dtype
        prev = self.plan.src
        for stage, rounds, uni in zip(self.plan.stages, self._stage_rounds,
                                      self._uniform_stages):
            if uni is not None:
                x = self._run_uniform(x, uni, out_dtype)
            else:
                x = self._run_general(x, stage, rounds, prev, out_dtype)
            prev = stage.annot_after
        return x


def execute_plan(plan: CommPlan, parts: dict[int, np.ndarray],
                 shape: tuple[int, ...], device=None,
                 times: dict[str, float] | None = None
                 ) -> dict[int, np.ndarray]:
    """Run ``plan`` on stacked rows of one torch device; ``parts`` maps
    each source device to its local shard (shaped by
    ``plan.src.device_box``).  The counterpart of the reference's
    ``runtime.backend.execute_plan``; returns the destination shards.
    ``device=None`` means ``cuda``; ``"cpu"`` runs on the host.

    ``times``, when given, accumulates the host-clock seconds of the
    call's parts, the device synchronized at each boundary: ``lower``
    (the plan's geometry), ``pack`` (stack the numpy shards, copy them to
    the device), ``move`` (the row moves on the device) and ``unpack``
    (copy back, cut out each destination shard)."""
    shape = tuple(shape)
    device = resolve_device(device)
    clock = _PartClock(times, device)
    order = DeviceOrder.for_plan(plan)
    lowering = PlanLowering(plan, shape, order, device)
    clock.lap("lower")
    stacked = torch.from_numpy(pack_shards(parts, plan.src, shape,
                                           len(order), order)).to(device)
    clock.lap("pack")
    out = lowering.apply(stacked)
    del stacked
    clock.lap("move")
    out = out.cpu().numpy()
    dst = plan.annots[-1]
    got = {dev: out[(order.pos(dev),) + tuple(
               slice(0, s) for s in box_shape(dst.device_box(dev, shape)))
               ].copy()
           for dev in dst.devices}
    clock.lap("unpack")
    return got


class _PartClock:
    """Adds the seconds since the last lap to ``times[part]``, after
    synchronizing a CUDA device; does nothing when ``times`` is None."""

    def __init__(self, times, device):
        self.times, self.device = times, device
        self.t = time.perf_counter()

    def lap(self, part: str) -> None:
        if self.times is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.times[part] = self.times.get(part, 0.0) + now - self.t
        self.t = now
