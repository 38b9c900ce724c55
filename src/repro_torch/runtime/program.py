"""Whole-graph execution on one torch device: compute + comm ExecItems.

The port of ``repro/runtime/program.py``.  A deduced
:class:`~repro_torch.core.graph.Graph` under one strategy runs with every
virtual device as one row of stacked buffers on a single torch device
(one GPU, or the CPU):

* each tensor that crosses a segment boundary lives as a stacked
  ``(mesh, *padded_local)`` buffer whose row ``order.pos(dev)`` holds
  device ``dev``'s local shard at the origin (heterogeneous boxes are
  zero-padded to the per-tensor elementwise-max box shape),
* compute ops run through the **specialization-class IR**
  (``core.lowered_ir``): maximal runs of compute ops between comm ops
  form segments, and each class of devices sharing one local program runs
  ONCE over its rows of the stacked buffers (``torch_ops.stacked_apply``):
  in the homogeneous SPMD case (one class, every device) the device rows
  simply fold into the batch, so each op is one call for the whole mesh;
  every input is sliced to the class's exact local shape before every
  op, and only live-outs are re-padded,
* a CommOp applies its resolved plan through
  :class:`~repro_torch.runtime.lowering.PlanLowering` on the same buffers.

The graph IR's ``attention`` op goes, per class, to the Hopper flash
kernel (B1) or to the plain composite, as ``kernels.policy`` decides from
the class's local shapes; with the device rows folded into the batch that
is one B1 launch per class.  Its backward stays the ``attn_grad_*``
composites, as in the reference.

Microbatched runs (pipeline schedules) loop over the microbatches in
Python, running the same emissions each time where the reference scans
one XLA program; the outputs are per-microbatch, as in the reference's
``run_microbatches``.

The per-segment emission (``run_segment`` / ``run_class``, the
reference's ``emit_segment``), the setup both lowerings share
(:class:`StackedGraph`) and the fetch (``fetch_shards``) serve this
module's whole-graph :class:`LoweredGraph` and the per-stage
``runtime.async_program.AsyncLoweredGraph`` alike, so the two run the same
class code on the same rows.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.lowered_ir import CommSlot, partition_graph
from repro_torch.core.op_semantics import result_dtype
from repro_torch.core.simulator import ShardedTensor
from repro_torch.core.specialize import resolve_comm_ops
from repro_torch.core.symbolic import bind_shape
from repro_torch.core.topology import Topology
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels.policy import select_attention_impl

from . import torch_ops
from .lowering import (DeviceOrder, LoweringStats, PlanLowering,
                       pack_shards, pad_shape)


def segment_liveness(graph: Graph, segments, fetches
                     ) -> dict[int, tuple[list[str], list[str]]]:
    """``id(segment) -> (live_in, live_out)``: values produced AND
    consumed inside one segment stay unpadded inside its branches; only
    live-outs (consumed by ops outside the segment, or fetched)
    materialize as stacked ``(mesh, *pad)`` buffers."""
    consumers: dict[str, set[int]] = {}
    for op in graph.ops:
        for t in op.inputs:
            consumers.setdefault(t.name, set()).add(id(op))
    fetch_set = set(fetches)
    out: dict[int, tuple[list[str], list[str]]] = {}
    for seg in segments:
        seg_ids = {id(op) for op in seg.ops}
        produced: list[str] = [op.outputs[0].name for op in seg.ops]
        produced_set = set(produced)
        live_in: list[str] = []
        for op in seg.ops:
            for t in op.inputs:
                if t.name not in produced_set and t.name not in live_in:
                    live_in.append(t.name)
        live_out = [n for n in produced
                    if n in fetch_set
                    or (consumers.get(n, set()) - seg_ids)]
        out[id(seg)] = (live_in, live_out)
    return out


def _rows_of(positions: list[int], device):
    """The row selector of a class: a slice when its rows are one
    contiguous run, else an index tensor."""
    lo, hi = positions[0], positions[-1] + 1
    if positions == list(range(lo, hi)):
        return slice(lo, hi)
    return torch.as_tensor(positions, device=device)


def fetch_shards(graph: Graph, k: int, shapes, order: DeviceOrder,
                 name: str, buf: torch.Tensor) -> ShardedTensor:
    """A stacked buffer -> ShardedTensor under ``name``'s annotation.
    Only each device's box is copied to the host: rows that hold no shard
    and the padding stay on the device.  On the CPU the parts are views
    into ``buf`` (callers never mutate shards in place)."""
    annot = graph.tensors[name].annots[k]
    shape = shapes[name]
    parts = {
        dev: buf[order.pos(dev)][
            tuple(slice(0, s) for s in annot.device_shape(dev, shape))
        ].cpu().numpy()
        for dev in annot.devices}
    return ShardedTensor(shape, annot, parts)


class RunTimes:
    """Host-clock seconds of a run's parts, accumulated across runs:
    packing leaves and copying them to the device (``pack``), the
    segments (``compute``, of which ``attention``), the comm plans
    (``comm``) and copying fetches back and unpacking them (``fetch``).
    Waiting for the device to finish what is fetched counts as
    ``compute``.  The device is synchronized at each boundary only while
    ``sync`` is set, so with it off the device parts are enqueue times."""

    PARTS = ("pack", "compute", "attention", "comm", "fetch")

    def __init__(self):
        self.sync = False
        self.reset()

    def reset(self) -> None:
        for p in self.PARTS:
            setattr(self, p, 0.0)

    def as_dict(self) -> dict[str, float]:
        return {p: getattr(self, p) for p in self.PARTS}

    def mark(self, part: str, t0: float, device: torch.device) -> float:
        """Add the seconds since ``t0`` to ``part``; returns now."""
        if self.sync and device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        setattr(self, part, getattr(self, part) + t - t0)
        return t


@dataclass
class SegmentRun:
    """What running one live compute segment needs: its class rows (a
    slice or an index tensor each), its live-outs and their pads."""

    seg: object
    class_rows: list
    live_out: list[str]
    out_pads: dict[str, tuple[int, ...]]


def attention(ins, attrs) -> torch.Tensor:
    """B1 over a class: the class rows fold into the batch, one launch."""
    n, b = ins[0].shape[:2]
    q, k, v = (x.reshape((-1,) + tuple(x.shape[2:])) for x in ins)
    y = flash.flash_attention(q, k, v, causal=attrs.get("causal", True))
    return y.reshape((n, b) + tuple(y.shape[1:]))


def run_class(seg, cls, rows, dtypes, tenv, device, times: RunTimes
              ) -> dict:
    """Run one class's local program over its rows; returns its
    exact-shaped ``(n_class, *local)`` values."""
    n = cls.n_devices
    exact: dict[str, torch.Tensor] = {}
    for op, spec in zip(seg.ops, cls.specs):
        if spec is None:
            continue        # this class does not run the op
        ins = []
        for t, shp in zip(op.inputs, spec.in_shapes):
            v = exact.get(t.name)
            if v is None:
                v = tenv[t.name][rows]
                if tuple(v.shape[1:]) != tuple(shp):
                    v = v[(slice(None),) + tuple(slice(0, s) for s in shp)]
            ins.append(v)
        name = op.outputs[0].name
        if spec.impl == "cuda":
            t0 = time.perf_counter()
            y = attention(ins, op.attrs)
            times.mark("attention", t0, device)
        else:
            y = torch_ops.stacked_apply(op.kind, ins, op.attrs,
                                        spec.out_shape, n, device)
            if y is None:   # no stacked form: one call per row
                y = torch.stack([torch_ops.local_apply(
                    op.kind, [x[j] for x in ins], op.attrs,
                    spec.out_shape, device) for j in range(n)])
        exact[name] = y.to(torch_ops.torch_dtype(dtypes[name]))
    return exact


def run_segment(sr: SegmentRun, tenv, *, n_mesh: int, device,
                times: RunTimes) -> None:
    """Run every class of one live segment over its rows and put the
    live-outs into ``tenv`` as stacked ``(n_mesh, *pad)`` buffers (rows
    of devices that do not run the segment stay zero)."""
    seg = sr.seg
    dtypes: dict[str, np.dtype] = {}
    for op in seg.ops:
        dtypes[op.outputs[0].name] = result_dtype(
            op.kind,
            [dtypes[t.name] if t.name in dtypes
             else torch_ops.numpy_dtype(tenv[t.name].dtype)
             for t in op.inputs])
    all_rows = slice(0, n_mesh)
    outs: dict[str, torch.Tensor] = {}
    for cls, rows in zip(seg.classes, sr.class_rows):
        exact = run_class(seg, cls, rows, dtypes, tenv, device, times)
        for name in sr.live_out:
            y = exact.get(name)
            if y is None:
                continue
            pad = sr.out_pads[name]
            if isinstance(rows, slice) and rows == all_rows \
                    and tuple(y.shape[1:]) == pad:
                outs[name] = y       # one class over every row
                continue
            buf = outs.get(name)
            if buf is None:
                buf = outs[name] = torch.zeros(
                    (n_mesh,) + pad,
                    dtype=torch_ops.torch_dtype(dtypes[name]),
                    device=device)
            buf[(rows,) + tuple(slice(0, s) for s in y.shape[1:])] = y
    for name in sr.live_out:
        tenv[name] = outs[name] if name in outs else torch.zeros(
            (n_mesh,) + sr.out_pads[name],
            dtype=torch_ops.torch_dtype(dtypes[name]), device=device)


class StackedGraph:
    """What both lowerings of a deduced graph + strategy onto one torch
    device share (this module's :class:`LoweredGraph` and
    ``runtime.async_program.AsyncLoweredGraph``): bound shapes, resolved
    comm plans, the device order (one stacked row per logical device),
    the leaves and fetches, the attention gate per class, packing leaves
    and fetching results."""

    def __init__(self, graph: Graph, strategy: int = 0, *, device,
                 shape_env: dict[str, int] | None = None,
                 topology: Topology | None = None,
                 fetches=None, times: RunTimes | None = None):
        self.graph = graph
        self.k = strategy
        self.device = torch.device(device)
        self.times = times if times is not None else RunTimes()
        env = shape_env or {}
        self.shapes = {name: bind_shape(t.shape, env)
                       for name, t in graph.tensors.items()}
        self.resolved = resolve_comm_ops(graph, strategy, topology,
                                         shape_env)
        self._plans = {id(rc.op): rc.plan for rc in self.resolved}

        devs: set[int] = set()
        for t in graph.tensors.values():
            if t.annots:
                devs |= set(t.annots[strategy].devices)
        for plan in self._plans.values():
            for annot in plan.annots:
                devs |= set(annot.devices)
        self.order = DeviceOrder(tuple(sorted(devs)))
        self.n_mesh = len(self.order)

        self.leaves = [o.outputs[0] for o in graph.ops
                       if o.kind in ("placeholder", "parameter")]
        self.fetches = list(fetches or [t.name for t in graph.sinks()])
        for f in self.fetches:
            if f not in graph.tensors:
                raise ValueError(f"unknown fetch tensor {f!r}")
        # placeholders carry a per-microbatch value; parameters are shared
        self._per_mb = {t.name for t in self.leaves
                        if t.producer is not None
                        and t.producer.kind == "placeholder"}
        self.stats = LoweringStats()

    def _lowering(self, op) -> PlanLowering:
        pl = PlanLowering(self._plans[id(op)], self.shapes[op.inputs[0].name],
                          self.order, self.device)
        self.stats.merge(pl.stats)
        return pl

    def _impl_of(self, op, dev) -> str:
        """Kernel dispatch, decided statically per specialization class
        from the device-LOCAL shard shapes; the decision takes part in the
        class partition, as in the reference."""
        if op.kind != "attention":
            return ""
        k, shapes = self.k, self.shapes
        qs = shapes[op.inputs[0].name]
        ks = shapes[op.inputs[1].name]
        return select_attention_impl(
            tuple(op.inputs[0].annots[k].device_shape(dev, qs)),
            tuple(op.inputs[1].annots[k].device_shape(dev, ks)),
            self.device)

    def _partition(self, ops=None):
        return partition_graph(self.graph, self.k, shapes=self.shapes,
                               impl_of=self._impl_of,
                               devices=self.order.devices, ops=ops)

    def _plan_segments(self, segments, fetches) -> dict[int, SegmentRun]:
        """``id(segment) -> SegmentRun`` for the live segments (dead ones
        never run), counting them and their attention classes into
        ``stats``."""
        graph, k = self.graph, self.k
        seg_live = segment_liveness(graph, segments, fetches)
        runs: dict[int, SegmentRun] = {}
        for seg in segments:
            live_out = seg_live[id(seg)][1]
            if not live_out:
                continue
            self.stats.compute_segments += 1
            self.stats.class_runs += seg.n_classes
            if seg.is_homogeneous():
                self.stats.straightline_segments += 1
            runs[id(seg)] = SegmentRun(
                seg,
                [_rows_of([self.order.pos(d) for d in cls.devices],
                          self.device) for cls in seg.classes],
                live_out,
                {n: pad_shape(graph.tensors[n].annots[k], self.shapes[n])
                 for n in live_out})
            for cls in seg.classes:
                for op, spec in zip(seg.ops, cls.specs):
                    if op.kind == "attention" and spec is not None:
                        if spec.impl == "cuda":
                            self.stats.kernel_dispatches += 1
                        else:
                            self.stats.ref_dispatches += 1
        return runs

    def _run_segment(self, sr: SegmentRun, tenv) -> None:
        run_segment(sr, tenv, n_mesh=self.n_mesh, device=self.device,
                    times=self.times)

    def _leaf(self, state, name: str) -> torch.Tensor:
        """Leaf ``name``'s shards packed into a stacked buffer on the
        device."""
        if name not in state:
            raise ValueError(f"missing leaf tensor {name!r}")
        stacked = pack_shards(state[name].parts,
                              self.graph.tensors[name].annots[self.k],
                              self.shapes[name], self.n_mesh, self.order)
        return torch.from_numpy(stacked).to(self.device)

    def _fetch(self, tenv) -> dict[str, ShardedTensor]:
        """The fetches to the host (timed as ``fetch``); the caller has
        waited for the device to produce them."""
        t0 = time.perf_counter()
        out = {name: fetch_shards(self.graph, self.k, self.shapes,
                                  self.order, name, tenv[name])
               for name in self.fetches}
        self.times.mark("fetch", t0, self.device)
        return out

    def _check_tf32(self) -> None:
        if self.device.type == "cuda":
            # fp32 products must be full fp32, as in the reference
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False


class LoweredGraph(StackedGraph):
    """A deduced graph + strategy lowered onto one torch device, reusable
    over fresh shard values.

    With ``num_microbatches=m > 1`` the graph passed in is the MICRO graph
    (shapes already scaled; ``Program.compile_micro``) and
    :meth:`run_microbatches` runs it once per microbatch."""

    def __init__(self, graph: Graph, strategy: int = 0, *, device,
                 shape_env: dict[str, int] | None = None,
                 topology: Topology | None = None,
                 fetches=None,
                 num_microbatches: int = 1, times: RunTimes | None = None):
        if num_microbatches < 1:
            raise ValueError(
                f"num_microbatches must be >= 1 (got {num_microbatches})")
        super().__init__(graph, strategy, device=device,
                         shape_env=shape_env, topology=topology,
                         fetches=fetches, times=times)
        self.num_microbatches = num_microbatches
        self._lowerings = {id(op): self._lowering(op)
                           for op in graph.comm_ops}
        self.ir = self._partition()
        self._segments = self._plan_segments(self.ir.segments,
                                             self.fetches)

    # -- emission ------------------------------------------------------------

    def _eval(self, tenv: dict) -> dict:
        for entry in self.ir.entries:
            t0 = time.perf_counter()
            if isinstance(entry, CommSlot):
                op = entry.op
                x = tenv[op.inputs[0].name]
                tenv[op.outputs[0].name] = self._lowerings[id(op)].apply(x)
                self.times.mark("comm", t0, self.device)
            else:
                sr = self._segments.get(id(entry))
                if sr is not None:      # dead code: nothing escapes
                    self._run_segment(sr, tenv)
                self.times.mark("compute", t0, self.device)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times.mark("compute", t0, self.device)
        return tenv

    def run(self, state: dict[str, ShardedTensor]
            ) -> dict[str, ShardedTensor]:
        """Execute once; ``state`` maps every leaf name (placeholder AND
        parameter) to its ShardedTensor under the strategy annotation."""
        if self.num_microbatches != 1:
            raise ValueError("microbatched program: use run_microbatches")
        self._check_tf32()
        t0 = time.perf_counter()
        tenv = {t.name: self._leaf(state, t.name) for t in self.leaves}
        self.times.mark("pack", t0, self.device)
        return self._fetch(self._eval(tenv))

    def run_microbatches(self, states: list[dict[str, ShardedTensor]]
                         ) -> list[dict[str, ShardedTensor]]:
        """Run the graph once per microbatch (microbatch ``j``'s
        placeholders in ``states[j]``; parameters read from
        ``states[0]``, packed once).  Returns per-microbatch fetches,
        bit-comparable to ``SimulatorExecutor.run_schedule``."""
        m = self.num_microbatches
        if m == 1:
            raise ValueError("unpipelined program: use run")
        if len(states) != m:
            raise ValueError(
                f"{len(states)} microbatch states for a {m}-microbatch "
                f"program")
        self._check_tf32()
        t0 = time.perf_counter()
        shared = {t.name: self._leaf(states[0], t.name)
                  for t in self.leaves if t.name not in self._per_mb}
        self.times.mark("pack", t0, self.device)
        results = []
        for st in states:
            t0 = time.perf_counter()
            tenv = dict(shared)
            for t in self.leaves:
                if t.name in self._per_mb:
                    tenv[t.name] = self._leaf(st, t.name)
            self.times.mark("pack", t0, self.device)
            results.append(self._fetch(self._eval(tenv)))
        return results
