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
"""

from __future__ import annotations

import time

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


def unpack_rows(graph: Graph, k: int, shapes, order: DeviceOrder,
                name: str, rows: np.ndarray) -> ShardedTensor:
    """A stacked host buffer -> ShardedTensor under ``name``'s annotation
    (parts are views into the buffer; callers never mutate shards in
    place)."""
    annot = graph.tensors[name].annots[k]
    shape = shapes[name]
    parts = {
        dev: rows[order.pos(dev)][
            tuple(slice(0, s) for s in annot.device_shape(dev, shape))]
        for dev in annot.devices}
    return ShardedTensor(shape, annot, parts)


class RunTimes:
    """Host-clock seconds of a run's parts, accumulated across runs:
    packing leaves and copying them to the device (``pack``), the
    segments (``compute``, of which ``attention``), the comm plans
    (``comm``) and copying fetches back and unpacking them (``fetch``).
    The device is synchronized at each boundary only while ``sync`` is
    set, so with it off the device parts are enqueue times."""

    PARTS = ("pack", "compute", "attention", "comm", "fetch")

    def __init__(self):
        self.sync = False
        self.reset()

    def reset(self) -> None:
        for p in self.PARTS:
            setattr(self, p, 0.0)

    def as_dict(self) -> dict[str, float]:
        return {p: getattr(self, p) for p in self.PARTS}


class LoweredGraph:
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
        self.graph = graph
        self.k = strategy
        self.device = torch.device(device)
        if num_microbatches < 1:
            raise ValueError(
                f"num_microbatches must be >= 1 (got {num_microbatches})")
        self.num_microbatches = num_microbatches
        self.times = times if times is not None else RunTimes()
        env = shape_env or {}
        self.shapes = {name: bind_shape(t.shape, env)
                       for name, t in graph.tensors.items()}
        resolved = resolve_comm_ops(graph, strategy, topology, shape_env)
        plans = {id(rc.op): rc.plan for rc in resolved}

        devs: set[int] = set()
        for t in graph.tensors.values():
            if t.annots:
                devs |= set(t.annots[strategy].devices)
        for plan in plans.values():
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
        self._lowerings: dict[int, PlanLowering] = {}
        for op in graph.comm_ops:
            pl = PlanLowering(plans[id(op)], self.shapes[op.inputs[0].name],
                              self.order, self.device)
            self._lowerings[id(op)] = pl
            self.stats.merge(pl.stats)

        # Kernel dispatch is decided statically, per specialization class,
        # from the device-LOCAL shard shapes; the decision takes part in
        # the class partition, as in the reference.
        k, shapes = strategy, self.shapes

        def impl_of(op, dev):
            if op.kind != "attention":
                return ""
            qs = shapes[op.inputs[0].name]
            ks = shapes[op.inputs[1].name]
            return select_attention_impl(
                tuple(op.inputs[0].annots[k].device_shape(dev, qs)),
                tuple(op.inputs[1].annots[k].device_shape(dev, ks)),
                self.device)

        self.ir = partition_graph(graph, strategy, shapes=shapes,
                                  impl_of=impl_of,
                                  devices=self.order.devices)
        self._seg_live = segment_liveness(graph, self.ir.segments,
                                          self.fetches)
        self._all_rows = slice(0, self.n_mesh)
        self._out_pads: dict[str, tuple[int, ...]] = {}
        self._class_rows: dict[int, list] = {}
        for seg in self.ir.segments:
            live_out = self._seg_live[id(seg)][1]
            if not live_out:
                continue                    # dead segment: never run
            self.stats.compute_segments += 1
            self.stats.class_runs += seg.n_classes
            if seg.is_homogeneous():
                self.stats.straightline_segments += 1
            for n in live_out:
                self._out_pads[n] = pad_shape(graph.tensors[n].annots[k],
                                              shapes[n])
            self._class_rows[id(seg)] = [
                _rows_of([self.order.pos(d) for d in cls.devices],
                         self.device) for cls in seg.classes]
            for cls in seg.classes:
                for op, spec in zip(seg.ops, cls.specs):
                    if op.kind == "attention" and spec is not None:
                        if spec.impl == "cuda":
                            self.stats.kernel_dispatches += 1
                        else:
                            self.stats.ref_dispatches += 1

    # -- emission ------------------------------------------------------------

    def _mark(self, part: str, t0: float) -> float:
        if self.times.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        setattr(self.times, part, getattr(self.times, part) + t - t0)
        return t

    def _attention(self, ins, attrs) -> torch.Tensor:
        """B1 over a class: the class rows fold into the batch, one
        launch."""
        n, b = ins[0].shape[:2]
        q, k, v = (x.reshape((-1,) + tuple(x.shape[2:])) for x in ins)
        y = flash.flash_attention(q, k, v,
                                  causal=attrs.get("causal", True))
        return y.reshape((n, b) + tuple(y.shape[1:]))

    def _run_class(self, seg, cls, rows, dtypes, tenv) -> dict:
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
                        v = v[(slice(None),)
                              + tuple(slice(0, s) for s in shp)]
                ins.append(v)
            name = op.outputs[0].name
            if spec.impl == "cuda":
                t0 = time.perf_counter()
                y = self._attention(ins, op.attrs)
                self._mark("attention", t0)
            else:
                y = torch_ops.stacked_apply(op.kind, ins, op.attrs,
                                            spec.out_shape, n, self.device)
                if y is None:   # no stacked form: one call per row
                    y = torch.stack([torch_ops.local_apply(
                        op.kind, [x[j] for x in ins], op.attrs,
                        spec.out_shape, self.device) for j in range(n)])
            exact[name] = y.to(torch_ops.torch_dtype(dtypes[name]))
        return exact

    def _run_segment(self, seg, tenv) -> None:
        live_in, live_out = self._seg_live[id(seg)]
        if not live_out:
            return              # dead code: nothing escapes
        dtypes: dict[str, np.dtype] = {}
        for op in seg.ops:
            dtypes[op.outputs[0].name] = result_dtype(
                op.kind,
                [dtypes[t.name] if t.name in dtypes
                 else torch_ops.numpy_dtype(tenv[t.name].dtype)
                 for t in op.inputs])
        outs: dict[str, torch.Tensor] = {}
        for cls, rows in zip(seg.classes, self._class_rows[id(seg)]):
            exact = self._run_class(seg, cls, rows, dtypes, tenv)
            for name in live_out:
                y = exact.get(name)
                if y is None:
                    continue
                pad = self._out_pads[name]
                if isinstance(rows, slice) and rows == self._all_rows \
                        and tuple(y.shape[1:]) == pad:
                    outs[name] = y       # one class over every row
                    continue
                buf = outs.get(name)
                if buf is None:
                    buf = outs[name] = torch.zeros(
                        (self.n_mesh,) + pad,
                        dtype=torch_ops.torch_dtype(dtypes[name]),
                        device=self.device)
                buf[(rows,) + tuple(slice(0, s) for s in y.shape[1:])] = y
        for name in live_out:
            tenv[name] = outs[name] if name in outs else torch.zeros(
                (self.n_mesh,) + self._out_pads[name],
                dtype=torch_ops.torch_dtype(dtypes[name]),
                device=self.device)

    def _eval(self, tenv: dict) -> dict:
        for entry in self.ir.entries:
            t0 = time.perf_counter()
            if isinstance(entry, CommSlot):
                op = entry.op
                x = tenv[op.inputs[0].name]
                tenv[op.outputs[0].name] = self._lowerings[id(op)].apply(x)
                self._mark("comm", t0)
            else:
                self._run_segment(entry, tenv)
                self._mark("compute", t0)
        return tenv

    # -- pack / unpack -------------------------------------------------------

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
        return {name: unpack_rows(self.graph, self.k, self.shapes,
                                  self.order, name,
                                  tenv[name].cpu().numpy())
                for name in self.fetches}

    def _check_tf32(self) -> None:
        if self.device.type == "cuda":
            # fp32 products must be full fp32, as in the reference
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def run(self, state: dict[str, ShardedTensor]
            ) -> dict[str, ShardedTensor]:
        """Execute once; ``state`` maps every leaf name (placeholder AND
        parameter) to its ShardedTensor under the strategy annotation."""
        if self.num_microbatches != 1:
            raise ValueError("microbatched program: use run_microbatches")
        self._check_tf32()
        t0 = time.perf_counter()
        tenv = {t.name: self._leaf(state, t.name) for t in self.leaves}
        self._mark("pack", t0)
        tenv = self._eval(tenv)
        t0 = time.perf_counter()
        out = self._fetch(tenv)
        self._mark("fetch", t0)
        return out

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
        self._mark("pack", t0)
        results = []
        for st in states:
            t0 = time.perf_counter()
            tenv = dict(shared)
            for t in self.leaves:
                if t.name in self._per_mb:
                    tenv[t.name] = self._leaf(st, t.name)
            self._mark("pack", t0)
            tenv = self._eval(tenv)
            t0 = time.perf_counter()
            results.append(self._fetch(tenv))
            self._mark("fetch", t0)
        return results

