"""Apply a :class:`~repro_torch.core.plan.CommPlan` across ranks.

The rank path's counterpart of ``runtime/lowering.py:PlanLowering`` and of
the reference's ``shard_map`` lowering (``repro/runtime/lowering.py``).
Rank ``r`` holds position ``r`` of the plan's :class:`DeviceOrder` (see
``launch.mesh``) and its own local shard: a tensor of its exact box, with
no padding across ranks.  Every rank lowers the same plan, so every rank
computes the same geometry and issues its part of every exchange in the
same order:

* copy groups (SR / AG / SplitAG / BSR): the stage's (src, dst) pairs
  fuse into rounds (``lowering._fuse_rounds``; each source and each
  destination at most once a round, the pairs of the reference's
  ``ppermute`` rounds, in the same order), and each round is one
  ``dist.batch_isend_irecv`` of this rank's sends and receives.  A rank
  with nothing to do in a round skips it; it never posts an empty batch,
* reduce groups (AR / RS / SplitAR / SplitRS) under ``reduction="exact"``:
  each destination receives every source's contribution and left-folds
  them in float64 in ``srcs`` order, then casts back: bitwise
  ``simulator.apply_plan``.  A group whose destinations are exactly its
  sources is one ``all_gather`` over its subgroup; any other group is
  point-to-point (each source sends its contribution to each other
  destination, one batch a group), which also serves sources of unequal
  boxes.  Under ``reduction="fast"`` (the reference's ``psum``) a group is
  one native-dtype ``all_reduce`` over the subgroup of its sources and
  destinations, destinations that are not sources adding zeros,
* ID / Slice: local retention.

Before that general path, a stage is asked the stacked lowering's three
static questions (``lowering.uniform_stage_static``, over the whole
world): a *uniform reduce* stage (every group a reduce onto its own
sources, the groups partitioning the world into equal subgroups with the
same relative slices) is this rank's one subgroup ``all_gather`` and
fold (one ``all_reduce`` under ``"fast"``), cut to the same local slice
on every rank; a *uniform identity* stage is a local re-slice, with
nothing exchanged or staged; a *uniform gather* stage (the full-mesh AG)
is one world ``all_gather`` of the equal local shards in place of the
n - 1 rounds.  Uniform stages count no pairs and no rounds, as in the
stacked lowering and the reference.

A general stage then assembles this rank's next box from local retention
and deliveries in the simulator's order (deliveries override retention
and earlier deliveries).  Heterogeneous boxes (``hsplits``) need no padding:
every message carries one group box, whose shape both ends know, and an
``all_gather`` runs only inside a reduce group, whose contributions all
have the group box's shape.  Only the fetch (:func:`gather_shards`) pads.

Subgroups are made when the plan is lowered, on every rank in the same
order (``dist.new_group`` is collective over the world), and cached in the
mesh.  Geometry is fixed when the plan is lowered; :meth:`apply` only
moves data.  Under ``gloo`` with CUDA shards every payload is staged
through host memory, explicitly, since gloo moves CPU tensors only.

:meth:`RankPlanLowering.post` and :meth:`PendingPlan.complete` split
:meth:`~RankPlanLowering.apply` in two, for the double-buffered channels
of ``runtime.dist_async_program``: ``post`` runs every stage but the
last, each of its rounds waited on before the next is posted, then posts
all of the last stage's rounds (every ``isend`` / ``irecv`` of this rank)
and returns without waiting on them; ``complete`` waits, copies what was
received back from host memory, and assembles this rank's next box.
``apply`` is ``post`` then ``complete``.  Only the last stage's rounds
are ever in flight together (and with its reduce groups), so only they
hold their staged host buffers at once; every earlier stage moves one
round at a time, as ``apply`` did before the split.  Reduce groups
and uniform stages run to their end inside ``post``: gloo's
``all_gather`` and ``all_reduce`` are synchronous, so a grad-reduce
channel holds its rank until every member has joined.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.plan import (CommPlan, box_contains, box_intersect,
                                   box_shape, rel_slices)

from .lowering import (DeviceOrder, LoweringStats, _fuse_rounds,
                       check_stage_coverage, uniform_stage_static)


@dataclass
class _RoundOps:
    """This rank's part of one fused round."""

    sends: list = field(default_factory=list)   # (peer, rel slice)
    recvs: list = field(default_factory=list)   # (peer, id(group), shape)


@dataclass
class _ReduceOps:
    """This rank's part of one reduce group."""

    group: object                 # the plan's reduce group
    mode: str                     # "local" | "gather" | "p2p" | "allreduce"
    pg: object = None             # the subgroup (gather / allreduce)
    members: tuple = ()           # the subgroup's ranks, sorted
    mine: "tuple | None" = None   # rel slice of this rank's contribution
    is_dst: bool = False
    shape: tuple = ()
    sends: list = field(default_factory=list)   # peers (p2p)
    recvs: dict = field(default_factory=dict)   # src dev -> peer (p2p)


@dataclass
class _Stage:
    rounds: list
    reduces: list
    #: the groups delivering to this rank, in the simulator's order:
    #: (group, rel slice of this rank's own box where it is the copy
    #: group's source, else None)
    pieces: list
    annot_after: object
    #: the stage's whole-mesh form (``lowering.uniform_stage_static``),
    #: or ``None`` for the general path above
    uni: "dict | None" = None


@dataclass
class PendingPlan:
    """A plan that :meth:`RankPlanLowering.post` has posted: the last
    stage's point-to-point work in flight, the buffers it receives into,
    and what the assembly of this rank's next box needs.  Completing it
    again returns the same shard."""

    lowering: "RankPlanLowering"
    dtype: torch.dtype
    x: "torch.Tensor | None" = None
    prev: object = None
    stage: "_Stage | None" = None
    works: list = field(default_factory=list)
    #: (id of the delivering group, the buffer it lands in)
    recvs: list = field(default_factory=list)
    #: id of the delivering group -> its piece, back on the device
    received: dict = field(default_factory=dict)
    reduced: dict = field(default_factory=dict)
    done: bool = False
    result: "torch.Tensor | None" = None

    def complete(self, times=None) -> "torch.Tensor | None":
        """Wait for the posted work; returns this rank's shard under the
        plan's last annotation (``None`` where it holds none).  ``times``
        gets the seconds of host staging, as in ``apply``."""
        if not self.done:
            self.result = self.lowering._complete(self, times)
            self.done = True
            self.x, self.received, self.reduced = None, {}, {}
        return self.result


class RankPlanLowering:
    """Applies one CommPlan's stages to this rank's local shard.

    ``order`` maps logical devices to ranks (position ``i`` is rank
    ``i``); it is the plan's own order, or a graph's when the plan is one
    of its comm ops.  All geometry, and every subgroup, is made at
    construction; :meth:`apply` only moves data.  ``stats`` holds the
    static geometry counts as the stacked path counts them (stages,
    uniform stages, copy pairs, rounds), every reduce group and those of
    them on a subgroup collective (as the reference counts both), and
    accumulates the rank path's traffic over every :meth:`apply`: the
    messages and bytes this rank sent point to point, the collectives it
    joined and the bytes it staged between its device and host memory."""

    def __init__(self, plan: CommPlan, shape: tuple[int, ...],
                 order: DeviceOrder, mesh, *, reduction: str = "exact"):
        if plan.src is None:
            raise ValueError("plan has no source annotation")
        if reduction not in ("exact", "fast"):
            raise ValueError(f"unknown reduction {reduction!r}; use "
                             f"'exact' or 'fast'")
        mesh.check_span(len(order))
        self.plan = plan
        self.shape = tuple(shape)
        self.order = order
        self.mesh = mesh
        self.reduction = reduction
        self.dev = mesh.logical_device(order)
        self.stats = LoweringStats()
        # a reducing plan (AR / RS / SplitAR / SplitRS groups) rather than
        # one that only copies
        self.has_reduce = any(g.reduce for s in plan.steps for g in s.groups)
        self._times = None
        self._stages: list[_Stage] = []
        prev = plan.src
        for stage in plan.stages:
            self._stages.append(self._stage_static(stage, prev))
            prev = stage.annot_after
        me = self.dev
        #: whether this rank takes part: it holds a shard before or after a
        #: stage, sends, receives or reduces, or joins a uniform stage's
        #: collective
        self.involved = (me is not None and me in plan.src.devices) or any(
            st.uni is not None or st.rounds or st.reduces
            or (me is not None and me in st.annot_after.devices)
            for st in self._stages)

    # -- static geometry -----------------------------------------------------

    def _rank(self, dev: int) -> int:
        return self.order.pos(dev)

    def _rel(self, annot, dev, box):
        return rel_slices(annot.device_box(dev, self.shape), box)

    def _stage_static(self, stage, prev) -> _Stage:
        me = self.dev
        pairs = []
        deliveries = [(g.box, g.dsts) for step in stage.steps
                      for g in step.groups]
        for step in stage.steps:
            for g in step.groups:
                for s in g.srcs:
                    sbox = prev.device_box(s, self.shape)
                    if not box_contains(sbox, g.box):
                        raise AssertionError(
                            f"src dev {s} box {sbox} does not contain "
                            f"group box {g.box}")
                if not g.reduce:
                    pairs += [(g.srcs[0], d, g) for d in g.dsts
                              if d != g.srcs[0]]
        check_stage_coverage(prev, stage.annot_after, deliveries, self.shape,
                             "+".join(st.kind for st in stage.steps))
        self.stats.stages += 1
        uni = uniform_stage_static(stage, prev, self.shape, self.order,
                                   self.mesh.world)
        if uni is not None:
            return self._uniform_static(stage, prev, uni)
        rounds = _fuse_rounds(pairs)
        self.stats.copy_pairs += len(pairs)
        self.stats.permute_rounds += len(rounds)
        mine = []
        for r in rounds:
            ops = _RoundOps()
            for s, d, g in r.pairs:
                if s == me:
                    ops.sends.append((self._rank(d), self._rel(prev, s,
                                                               g.box)))
                if d == me:
                    ops.recvs.append((self._rank(s), id(g),
                                      box_shape(g.box)))
            if ops.sends or ops.recvs:
                mine.append(ops)
        reduces, pieces = [], []
        for step in stage.steps:
            for g in step.groups:
                if g.reduce:
                    self.stats.reduce_groups += 1
                    op = self._reduce_static(g, prev)
                    if op is not None:
                        reduces.append(op)
                if me in g.dsts:
                    own = not g.reduce and me == g.srcs[0]
                    pieces.append((g, self._rel(prev, me, g.box)
                                   if own else None))
        return _Stage(mine, reduces, pieces, stage.annot_after)

    def _uniform_static(self, stage, prev, uni) -> _Stage:
        """This rank's part of a uniform stage, which counts no pairs and
        no rounds (as ``PlanLowering`` counts it).  Every rank holds a
        device of the plan here (the order spans the world):

        * reduce: the group holding this rank is one subgroup
          ``all_gather`` (``all_reduce`` under ``"fast"``) with its fold;
          every group's subgroup is made on every rank, in plan order,
        * ident: a local re-slice, nothing exchanged or staged,
        * gather: one world ``all_gather`` of the equal local shards,
          each rank cutting its tiles out of the sources' shards."""
        if uni["kind"] == "reduce":
            self.stats.uniform_reduce_stages += 1
            mine = None
            for step in stage.steps:
                for g in step.groups:
                    self.stats.reduce_groups += 1
                    op = self._reduce_static(g, prev)
                    if op is not None:
                        mine = op
            uni = dict(uni, op=mine)
        else:
            self.stats.uniform_copy_stages += 1
        return _Stage([], [], [], stage.annot_after, uni)

    def _reduce_static(self, g, prev) -> "_ReduceOps | None":
        """This rank's part of reduce group ``g``; the group's subgroup is
        made here on every rank, member or not."""
        me = self.dev
        srcs, dsts = list(g.srcs), list(g.dsts)
        if self.reduction == "fast":
            members = tuple(sorted({self._rank(d) for d in srcs + dsts}))
            mode = "allreduce"
        elif set(dsts) == set(srcs):
            members = tuple(sorted(self._rank(s) for s in srcs))
            mode = "gather"
        else:
            members = ()
            mode = "p2p"
        if len(members) == 1:
            mode = "local"        # one device sums its own contribution
        pg = None
        if mode in ("gather", "allreduce"):
            pg = self.mesh.group(members)
            self.stats.grouped_reduces += 1
        if me not in srcs and me not in dsts:
            return None
        op = _ReduceOps(g, mode, pg, members,
                        self._rel(prev, me, g.box) if me in srcs else None,
                        me in dsts, box_shape(g.box))
        if mode == "p2p":
            if me in srcs:
                op.sends = [self._rank(d) for d in dsts if d != me]
            if me in dsts:
                op.recvs = {s: self._rank(s) for s in srcs if s != me}
        return op

    # -- data movement -------------------------------------------------------

    def _stage_copy(self, t: torch.Tensor, device) -> torch.Tensor:
        """Copy ``t`` between the device and host memory, counting its
        bytes and, while a run is timed, its seconds."""
        t0 = time.perf_counter()
        self.stats.staged_bytes += t.numel() * t.element_size()
        t = t.to(device)
        if self._times is not None:
            self._times.staging += time.perf_counter() - t0
        return t

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A payload as the backend sends it: contiguous, and on the host
        when staged."""
        t = t.contiguous()
        return self._stage_copy(t, "cpu") if self.mesh.staged else t

    def _in(self, t: torch.Tensor, device) -> torch.Tensor:
        return self._stage_copy(t, device) if self.mesh.staged else t

    def _buf(self, shape, dtype, device) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype,
                           device="cpu" if self.mesh.staged else device)

    def _post_exchange(self, sends, recvs, dtype, device):
        """Post one ``batch_isend_irecv`` of ``sends`` ((peer, tensor)) and
        ``recvs`` ((peer, shape)); returns its work handles and the
        buffers the receives land in."""
        ops, bufs = [], []
        for peer, t in sends:
            t = self._out(t)
            self.stats.p2p_messages += 1
            self.stats.p2p_bytes += t.numel() * t.element_size()
            ops.append(dist.P2POp(dist.isend, t, peer))
        for peer, shape in recvs:
            b = self._buf(shape, dtype, device)
            bufs.append(b)
            ops.append(dist.P2POp(dist.irecv, b, peer))
        return (dist.batch_isend_irecv(ops) if ops else []), bufs

    def _exchange(self, sends, recvs, dtype, device) -> list[torch.Tensor]:
        """One ``batch_isend_irecv``, waited on; returns the received
        tensors on ``device``."""
        works, bufs = self._post_exchange(sends, recvs, dtype, device)
        for w in works:
            w.wait()
        return [self._in(b, device) for b in bufs]

    def _land(self, pend: "PendingPlan"):
        """Wait for ``pend``'s posted rounds and copy what they received
        back to the device, into ``pend.received``."""
        for w in pend.works:
            w.wait()
        pend.received.update({key: self._in(b, self.mesh.device)
                              for key, b in pend.recvs})
        pend.works, pend.recvs = [], []

    def _reduce(self, x, op: _ReduceOps, dtype, device):
        """Run this rank's part of one reduce group; returns the reduced
        piece when this rank is a destination."""
        g = op.group
        contrib = x[op.mine] if op.mine is not None else None
        if op.mode == "local":
            return contrib.to(torch.float64).to(dtype) if op.is_dst \
                else None
        if op.mode == "allreduce":
            t = self._out(contrib if contrib is not None else
                          torch.zeros(op.shape, dtype=dtype, device=device))
            if not self.mesh.staged:
                t = t.clone()     # all_reduce writes in place: not into x
            self.stats.collectives += 1
            dist.all_reduce(t, group=op.pg)
            return self._in(t, device) if op.is_dst else None
        if op.mode == "gather":
            t = self._out(contrib)
            outs = [torch.empty_like(t) for _ in op.members]
            self.stats.collectives += 1
            dist.all_gather(outs, t, group=op.pg)
            got = {s: contrib if s == self.dev else
                   self._in(outs[op.members.index(self._rank(s))], device)
                   for s in g.srcs}
        else:
            recvd = self._exchange(
                [(p, contrib) for p in op.sends],
                [(p, op.shape) for p in op.recvs.values()], dtype, device)
            if not op.is_dst:
                return None
            got = dict(zip(op.recvs, recvd))
            if contrib is not None:
                got[self.dev] = contrib
        if not op.is_dst:
            return None
        acc = got[g.srcs[0]].to(torch.float64)
        for s in g.srcs[1:]:
            acc = acc + got[s].to(torch.float64)
        return acc

    def _run_uniform(self, x, st: _Stage, prev, dtype, device):
        """This rank's part of a uniform stage (:meth:`_uniform_static`);
        returns its next shard."""
        uni = st.uni
        if uni["kind"] == "ident":
            nbox = st.annot_after.device_box(self.dev, self.shape)
            return x[self._rel(prev, self.dev, nbox)]
        if uni["kind"] == "reduce":
            piece = self._reduce(x, uni["op"], dtype, device)
            return piece[uni["piece_rel"]].to(dtype)
        t = self._out(x)
        got = [torch.empty_like(t) for _ in range(self.mesh.world)]
        self.stats.collectives += 1
        dist.all_gather(got, t)
        me = self.mesh.rank
        out = torch.empty(uni["next_pad"], dtype=dtype, device=device)
        for rows, piece_rel, dst_rel in uni["tiles"]:
            src = rows[me]
            out[dst_rel] = x[piece_rel] if src == me else \
                self._in(got[src][piece_rel], device)
        return out

    def apply(self, x: "torch.Tensor | None", dtype: torch.dtype,
              times=None) -> "torch.Tensor | None":
        """Run the plan's stages on this rank's shard ``x`` (``None`` where
        this rank holds none under the plan's source annotation); returns
        its shard under the plan's last annotation, or ``None``.  Every
        rank of the mesh calls this with the same plan.  ``times``, when
        given (``runtime.dist_program.RankRunTimes``), gets the seconds of
        host staging added to its ``staging``."""
        return self.post(x, dtype, times).complete(times)

    def post(self, x: "torch.Tensor | None", dtype: torch.dtype,
             times=None) -> PendingPlan:
        """:meth:`apply` up to the last stage's point-to-point exchange,
        whose rounds are all posted and none waited on: every stage before
        it (each round waited on before the next is posted), and the last
        stage's reduce groups, run to their end.  Every rank of the
        mesh posts the same plans in the same order; this rank completes
        the returned :class:`PendingPlan` when it needs the result."""
        self._times = times
        try:
            return self._post(x, dtype)
        finally:
            self._times = None

    def _post(self, x, dtype) -> PendingPlan:
        device = self.mesh.device
        prev = self.plan.src
        if x is not None:
            x = x.to(dtype)
        last = len(self._stages) - 1
        for i, st in enumerate(self._stages):
            if st.uni is not None:
                x, prev = self._run_uniform(x, st, prev, dtype,
                                            device), st.annot_after
                continue
            pend = PendingPlan(self, dtype, x, prev, st)
            for ops in st.rounds:
                works, bufs = self._post_exchange(
                    [(p, x[rel]) for p, rel in ops.sends],
                    [(p, shape) for p, _, shape in ops.recvs], dtype,
                    device)
                pend.works += works
                pend.recvs += [(key, b) for (_, key, _), b in
                               zip(ops.recvs, bufs)]
                if i < last:
                    self._land(pend)
            pend.reduced = {id(op.group): self._reduce(x, op, dtype, device)
                            for op in st.reduces}
            if i == last:
                return pend
            x, prev = self._assemble(pend), st.annot_after
        return PendingPlan(self, dtype, done=True, result=x)

    def _complete(self, pend: PendingPlan, times) -> "torch.Tensor | None":
        self._times = times
        try:
            return self._assemble(pend)
        finally:
            self._times = None

    def _assemble(self, pend: PendingPlan) -> "torch.Tensor | None":
        """Wait for a posted stage's exchanges, then assemble this rank's
        next box from local retention and the deliveries."""
        device, dtype, me = self.mesh.device, pend.dtype, self.dev
        self._land(pend)
        received = pend.received
        st, prev, x = pend.stage, pend.prev, pend.x
        nxt = st.annot_after
        if me is None or me not in nxt.devices:
            return None
        nbox = nxt.device_box(me, self.shape)
        out = torch.zeros(box_shape(nbox), dtype=dtype, device=device)
        if me in prev.devices:
            pbox = prev.device_box(me, self.shape)
            inter = box_intersect(pbox, nbox)
            if inter is not None:
                out[rel_slices(nbox, inter)] = x[rel_slices(pbox, inter)]
        for g, own in st.pieces:
            if g.reduce:
                piece = pend.reduced[id(g)]
            elif own is None:
                piece = received[id(g)]
            else:
                piece = x[own]
            inter = box_intersect(g.box, nbox)
            if inter is not None:
                out[rel_slices(nbox, inter)] = \
                    piece[rel_slices(g.box, inter)]
        return out


def gather_shards(mesh, order: DeviceOrder, annot, shape, local,
                  dtype: torch.dtype, stats: LoweringStats | None = None
                  ) -> dict[int, np.ndarray]:
    """Every device's shard under ``annot`` on every rank, as host numpy
    arrays; ``local`` is this rank's (``None`` where it holds none).  When
    every rank holds a shard of one box shape it is one ``all_gather`` over
    the world; otherwise one ``broadcast`` from each holder, in device
    order.  Collective over the world."""
    shape = tuple(shape)
    boxes = {dev: tuple(annot.device_shape(dev, shape))
             for dev in annot.devices}
    cdev = torch.device("cpu") if mesh.staged else mesh.device

    def out(t):
        t = t.contiguous()
        if cdev.type == "cpu" and t.device.type != "cpu":
            if stats is not None:
                stats.staged_bytes += t.numel() * t.element_size()
            t = t.cpu()
        return t

    holders = [order.pos(d) for d in annot.devices]
    if sorted(holders) == list(range(mesh.world)) and \
            len(set(boxes.values())) == 1:
        t = out(local.to(dtype))
        got = [torch.empty_like(t) for _ in range(mesh.world)]
        dist.all_gather(got, t)
        if stats is not None:
            stats.collectives += 1
        return {dev: got[order.pos(dev)].cpu().numpy()
                for dev in annot.devices}
    parts = {}
    for dev in sorted(annot.devices, key=order.pos):
        src = order.pos(dev)
        if src == mesh.rank:
            t = out(local.to(dtype))
        else:
            t = torch.empty(boxes[dev], dtype=dtype, device=cdev)
        dist.broadcast(t, src=src)
        if stats is not None:
            stats.collectives += 1
        parts[dev] = t.cpu().numpy()
    return parts

