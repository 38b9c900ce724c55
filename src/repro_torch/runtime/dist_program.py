"""Whole-graph execution across ranks: compute + comm ExecItems.

The rank path's counterpart of ``runtime/program.py:LoweredGraph`` (and of
the reference's ``shard_map`` program, ``repro/runtime/program.py``).  A
deduced graph under one strategy runs with every logical device on its
own rank (``launch.mesh``: position ``i`` of the graph's device order is
rank ``i``):

* each rank keeps its own row of every buffer: a tensor of its device's
  exact local shard, with a leading axis of one so that the class code of
  the stacked path runs on it unchanged,
* compute runs through the specialization-class IR (``core.lowered_ir``)
  and ``runtime.program.run_class``, the code ``TorchExecutor`` and
  ``AsyncExecutor`` share: the rank runs its own class of each live
  segment over its one row, and idles through a segment its class does
  not run (the reference's zero branch).  The graph IR's ``attention``
  goes to B1 (the Hopper flash kernel) or the plain version as
  ``kernels.policy`` decides from the rank's local shapes, so B1 is one
  launch per rank per attention layer at the rank's local q shape,
* comm ops run their resolved plans through
  ``runtime.dist_lowering.RankPlanLowering`` under the exact reduction
  (the simulator's float64 fold in ``srcs`` order),
* the fetch gathers each fetched tensor's shards onto every rank
  (``dist_lowering.gather_shards``), so every rank returns the full
  ``ShardedTensor``\\ s, and every rank's host state stays identical.

Microbatched runs loop over the microbatches as
``LoweredGraph.run_microbatches`` does.  Dtypes are fixed once from the
leaves (the same on every rank): a rank that does not hold a tensor still
knows what it receives.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.lowered_ir import CommSlot
from repro_torch.core.op_semantics import result_dtype
from repro_torch.core.simulator import ShardedTensor
from repro_torch.core.topology import Topology

from . import torch_ops
from .dist_lowering import RankPlanLowering, gather_shards
from .lowering import LoweringStats
from .program import RunTimes, StackedGraph, run_class, segment_liveness


class RankRunTimes(RunTimes):
    """``RunTimes`` of the rank path: ``comm`` splits into ``staging``
    (copies between the device and host memory) and the exchanges
    themselves (``collective`` = comm - staging, in :meth:`as_dict`)."""

    PARTS = RunTimes.PARTS + ("staging",)

    def as_dict(self) -> dict[str, float]:
        out = super().as_dict()
        out["collective"] = self.comm - self.staging
        return out


class RankLoweredGraph(StackedGraph):
    """A deduced graph + strategy lowered onto this rank, reusable over
    fresh shard values.  Every rank of ``mesh`` builds one from the same
    arguments (comm plans make their subgroups here, in the same order on
    every rank) and runs it with the same state.

    With ``num_microbatches=m > 1`` the graph passed in is the MICRO graph
    and :meth:`run_microbatches` runs it once per microbatch."""

    def __init__(self, graph: Graph, strategy: int = 0, *, mesh,
                 shape_env: dict[str, int] | None = None,
                 topology: Topology | None = None, fetches=None,
                 num_microbatches: int = 1,
                 times: RankRunTimes | None = None):
        if num_microbatches < 1:
            raise ValueError(
                f"num_microbatches must be >= 1 (got {num_microbatches})")
        super().__init__(graph, strategy, device=mesh.device,
                         shape_env=shape_env, topology=topology,
                         fetches=fetches,
                         times=times if times is not None
                         else RankRunTimes())
        mesh.check_span(self.n_mesh)
        self.mesh = mesh
        self.num_microbatches = num_microbatches
        self.dev = mesh.logical_device(self.order)
        self._lowerings = {
            id(op): RankPlanLowering(
                self._plans[id(op)], self.shapes[op.inputs[0].name],
                self.order, mesh)
            for op in graph.comm_ops}
        for lw in self._lowerings.values():
            self.stats.merge(lw.stats)
        self.ir = self._partition()
        self._runs = self._rank_segments()
        self._dtypes: dict[str, np.dtype] | None = None
        #: fetch traffic (gathers onto every rank), accumulated
        self.fetch_stats = LoweringStats()

    def _rank_segments(self) -> dict[int, tuple]:
        """``id(segment) -> (this rank's class as a one-device class,
        live-outs)`` for the live segments this rank's device runs; counts
        the segments and this rank's attention dispatches into
        ``stats``."""
        live = segment_liveness(self.graph, self.ir.segments, self.fetches)
        runs = {}
        for seg in self.ir.segments:
            live_out = live[id(seg)][1]
            if not live_out:
                continue
            self.stats.compute_segments += 1
            ci = seg.class_of(self.dev) if self.dev is not None else None
            if ci is None:
                continue           # this rank idles through the segment
            self.stats.class_runs += 1
            if seg.is_homogeneous():
                self.stats.straightline_segments += 1
            cls = dataclasses.replace(seg.classes[ci], devices=(self.dev,))
            for op, spec in zip(seg.ops, cls.specs):
                if op.kind == "attention" and spec is not None:
                    if spec.impl == "cuda":
                        self.stats.kernel_dispatches += 1
                    else:
                        self.stats.ref_dispatches += 1
            runs[id(seg)] = (seg, cls, live_out)
        return runs

    @property
    def comm_stats(self) -> LoweringStats:
        """The comm plans' traffic so far on this rank, summed."""
        total = LoweringStats()
        for lw in self._lowerings.values():
            total.merge(lw.stats)
        return total

    # -- dtypes ---------------------------------------------------------------

    def _fix_dtypes(self, state) -> dict[str, np.dtype]:
        """Every tensor's dtype, from the leaves' (promoted over their
        shards, as packing does), the same on every rank."""
        dtypes: dict[str, np.dtype] = {}
        for t in self.leaves:
            if t.name not in state:
                raise ValueError(f"missing leaf tensor {t.name!r}")
            dtypes[t.name] = np.result_type(
                *[np.asarray(p).dtype for p in state[t.name].parts.values()])
        for op in self.graph.ops:
            if op.kind in ("placeholder", "parameter"):
                continue
            name = op.outputs[0].name
            if op.kind == "comm":
                dtypes[name] = dtypes[op.inputs[0].name]
            else:
                dtypes[name] = result_dtype(
                    op.kind, [dtypes[t.name] for t in op.inputs])
        return dtypes

    def _tdtype(self, name: str) -> torch.dtype:
        return torch_ops.torch_dtype(self._dtypes[name])

    # -- emission -------------------------------------------------------------

    def _leaf(self, state, name: str):
        """This rank's shard of leaf ``name`` on its device, as a row of
        one; ``None`` where its device holds none."""
        annot = self.graph.tensors[name].annots[self.k]
        if self.dev is None or self.dev not in annot.devices:
            return None
        arr = np.asarray(state[name].parts[self.dev])
        want = tuple(annot.device_shape(self.dev, self.shapes[name]))
        if tuple(arr.shape) != want:
            raise ValueError(f"dev {self.dev}: shard shape {arr.shape} != "
                             f"{want} expected by the annotation")
        x = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=self.device, dtype=self._tdtype(name))
        return x.unsqueeze(0)

    def _eval(self, tenv: dict) -> dict:
        rows = slice(None)
        for entry in self.ir.entries:
            t0 = time.perf_counter()
            if isinstance(entry, CommSlot):
                op = entry.op
                x = tenv.get(op.inputs[0].name)
                y = self._lowerings[id(op)].apply(
                    None if x is None else x[0],
                    self._tdtype(op.inputs[0].name), times=self.times)
                if y is not None:
                    tenv[op.outputs[0].name] = y.unsqueeze(0)
                self.times.mark("comm", t0, self.device)
                continue
            run = self._runs.get(id(entry))
            if run is not None:
                seg, cls, live_out = run
                exact = run_class(seg, cls, rows, self._dtypes, tenv,
                                  self.device, self.times)
                for name in live_out:
                    if name in exact:
                        tenv[name] = exact[name]
            self.times.mark("compute", t0, self.device)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times.mark("compute", t0, self.device)
        return tenv

    def _fetch(self, tenv) -> dict[str, ShardedTensor]:
        t0 = time.perf_counter()
        out = {}
        for name in self.fetches:
            annot = self.graph.tensors[name].annots[self.k]
            x = tenv.get(name)
            parts = gather_shards(self.mesh, self.order, annot,
                                  self.shapes[name],
                                  None if x is None else x[0],
                                  self._tdtype(name), self.fetch_stats)
            out[name] = ShardedTensor(self.shapes[name], annot, parts)
        self.times.mark("fetch", t0, self.device)
        return out

    def _check_dtypes(self, state) -> None:
        dtypes = self._fix_dtypes(state)
        if self._dtypes is None:
            self._dtypes = dtypes
        elif dtypes != self._dtypes:
            raise ValueError("leaf dtypes changed since the first run of "
                             "this lowered graph")

    def run(self, state: dict[str, ShardedTensor]
            ) -> dict[str, ShardedTensor]:
        """Execute once; ``state`` maps every leaf name (placeholder AND
        parameter) to its ShardedTensor under the strategy annotation, the
        same on every rank."""
        if self.num_microbatches != 1:
            raise ValueError("microbatched program: use run_microbatches")
        self._check_tf32()
        self._check_dtypes(state)
        t0 = time.perf_counter()
        tenv = {}
        for t in self.leaves:
            x = self._leaf(state, t.name)
            if x is not None:
                tenv[t.name] = x
        self.times.mark("pack", t0, self.device)
        return self._fetch(self._eval(tenv))

    def run_microbatches(self, states: list[dict[str, ShardedTensor]]
                         ) -> list[dict[str, ShardedTensor]]:
        """Run the graph once per microbatch (microbatch ``j``'s
        placeholders in ``states[j]``; parameters read from
        ``states[0]``, moved to the device once)."""
        m = self.num_microbatches
        if m == 1:
            raise ValueError("unpipelined program: use run")
        if len(states) != m:
            raise ValueError(
                f"{len(states)} microbatch states for a {m}-microbatch "
                f"program")
        self._check_tf32()
        self._check_dtypes(states[0])
        t0 = time.perf_counter()
        shared = {}
        for t in self.leaves:
            if t.name not in self._per_mb:
                x = self._leaf(states[0], t.name)
                if x is not None:
                    shared[t.name] = x
        self.times.mark("pack", t0, self.device)
        results = []
        for st in states:
            t0 = time.perf_counter()
            tenv = dict(shared)
            for t in self.leaves:
                if t.name in self._per_mb:
                    x = self._leaf(st, t.name)
                    if x is not None:
                        tenv[t.name] = x
            self.times.mark("pack", t0, self.device)
            results.append(self._fetch(self._eval(tenv)))
        return results
