"""Async MPMD execution on one torch device: one program per (virtual)
pipeline stage and phase.

The port of ``repro/runtime/async_program.py``.  ``runtime.program.
LoweredGraph`` runs the whole graph, every stage, once per microbatch;
here the graph's ops are bucketed by ``(virtual stage, phase)``
(``core.schedule.assign_stages``: exactly the buckets the
SimulatorExecutor's timetable ticks execute), each bucket becomes its OWN
program over the same stacked ``(mesh, *pad)`` rows, and the dispatch
loop walks the explicit 1F1B / GPipe / interleaved timetable, issuing
programs as their inputs become ready:

* **per-stage programs**: a bucket's compute ops run through the SAME
  specialization-class emission as the whole-graph lowering
  (``runtime.program.run_segment`` over a ``partition_graph`` of the
  bucket's ops), so per-class calls, dtype chains and pad/unpad slicing
  are those of ``TorchExecutor``,
* **double-buffered P2P**: stage-boundary comm ops (activation sends,
  cotangent sends, interleaved wrap-arounds) are split OUT of the
  receiving stage's program into :class:`CommChannel`\\ s issued the
  moment the producing tick has been issued, through a bounded 2-slot
  in-flight window (a channel's third issue first waits on the host for
  its oldest transfer: the reference's back-pressure),
* **grad-reduce inside the backward**: a backward tick's trailing
  grad-reduce (output unconsumed inside the bucket) is hoisted out of the
  stage program and issued right after the tick.

On a CUDA device each virtual stage issues on its own
``torch.cuda.Stream`` and the channels on one more, so what XLA's async
dispatch overlaps in the reference overlaps here on the card.  Every
issue records an event after it; a consumer on another stream waits on
that event before it reads, and marks the tensor with
``record_stream`` so that the caching allocator does not hand its memory
to the producer's stream while the consumer may still read it.  The
three kernel wrappers launch on ``torch.cuda.current_stream()``, so B1
runs on its stage's stream.  On the CPU the same loop runs in order.

Two deliberate divergences from the reference:

* no one-in-flight collective window (the reference's ``_coll_window``):
  it works around an XLA host-CPU rendezvous deadlock that one process
  issuing to CUDA streams does not have;
* each microbatch is fetched as soon as its last tick has been issued
  (the host waits for that microbatch's fetched tensors, then copies
  them), not all at the end: at full width one microbatch's gradients
  are as large as the weights, and four kept until the end do not fit
  one card.  No bit changes.

``serialize=True`` synchronizes the device after every issue: the
baseline the overlap is measured against.

The bucketing and channel split (:func:`bucket_graph`, :func:`bucket_io`)
and the timetable entry points (:class:`TimetableRuns`) are shared with
the rank lowering, ``runtime.dist_async_program``.
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass, field

import torch

from repro_torch.core.graph import Graph
from repro_torch.core.lowered_ir import CommSlot
from repro_torch.core.schedule import (SCHEDULES, PipelineSchedule,
                                       ScheduleError, assign_stages,
                                       infer_virtual_stages)
from repro_torch.core.simulator import ShardedTensor
from repro_torch.core.specialize import construct_pipelines
from repro_torch.core.topology import Topology

from .program import RunTimes, StackedGraph


def _phase_of(op) -> str:
    return "bwd" if op.attrs.get("phase") == "bwd" else "fwd"


@dataclass
class StageProgram:
    """One (virtual stage, phase) bucket as its own program:
    ``fn(in_buffers) -> out_buffers``, all stacked ``(mesh, *pad)``
    tensors."""

    stage: int
    phase: str
    ops: list
    in_names: list[str]
    out_names: list[str]
    fn: object


@dataclass
class CommChannel:
    """A comm op split out of its stage program and issued at the tick
    that produces its input.

    ``kind`` is ``"p2p"`` (activation / cotangent / wrap-around send)
    or ``"reduce"`` (grad-reduce and other reducing plans).  ``slots``
    bounds the in-flight window: issuing past it waits on the host for
    the oldest outstanding transfer first (the double-buffer
    discipline); ``inflight`` holds the issued transfers: their events
    here, their posted plans on ranks (``runtime.dist_async_program``,
    where ``fn`` is the channel's ``RankPlanLowering``)."""

    op: object
    kind: str
    trigger: tuple[int, str]
    in_name: str
    out_name: str
    fn: object
    slots: int = 2
    inflight: deque = field(default_factory=deque)


@dataclass
class TickRecord:
    """One issued stage program: the host clock (``time.perf_counter``)
    around its issue, and its events (CUDA only) bracketing its work on
    its stage's stream."""

    stage: int
    microbatch: int
    phase: str
    host_start: float = 0.0
    host_end: float = 0.0
    start: object = None
    end: object = None


@dataclass
class Buckets:
    """A graph's schedulable ops bucketed by ``(virtual stage, phase)``
    (:func:`bucket_graph`)."""

    pipelines: list
    n_stages: int
    v: int
    #: tensor name -> ids of the ops that read it
    consumers: dict
    #: ``(key, inline ops, [(split comm op, trigger key)])``, in key order
    buckets: list

    @property
    def n_virtual(self) -> int:
        return self.n_stages * self.v


def bucket_graph(graph: Graph, strategy: int, resolved,
                 virtual_stages_per_device: int | None = None) -> Buckets:
    """Bucket the schedulable ops exactly like the simulator's ticks
    (``assign_stages``, phase), and split out of each bucket the comm ops
    that become channels: a comm op whose input crosses a bucket boundary
    (boundary P2P), or whose output escapes the bucket untouched
    (trailing grad-reduce / wrap-around send).  A channel is triggered by
    the bucket that produces its input (``home``; the bucket itself for a
    leaf).  Shared by the one-device lowering (:class:`AsyncLoweredGraph`)
    and the rank lowering (``runtime.dist_async_program``).  Raises
    ``ScheduleError`` when the graph wraps more than ``v`` allows."""
    pipelines = construct_pipelines(graph, strategy, resolved_comms=resolved)
    n_stages = max((p.n_stages for p in pipelines), default=1)
    inferred = infer_virtual_stages(graph, strategy, pipelines)
    v = inferred if virtual_stages_per_device is None \
        else virtual_stages_per_device
    stage_of = assign_stages(graph, strategy, pipelines,
                             virtual_stages_per_device=v)

    consumers: dict[str, set[int]] = {}
    for op in graph.ops:
        for t in op.inputs:
            consumers.setdefault(t.name, set()).add(id(op))

    buckets: dict[tuple[int, str], list] = {}
    for op in graph.ops:
        if op.kind in ("placeholder", "parameter"):
            continue
        buckets.setdefault(
            (stage_of[id(op)], _phase_of(op)), []).append(op)

    def home(op, key):
        """The bucket that produces ``op``'s input (``key`` itself for a
        leaf)."""
        producer = graph.tensors[op.inputs[0].name].producer
        if producer is None or \
                producer.kind in ("placeholder", "parameter"):
            return key
        return stage_of[id(producer)], _phase_of(producer)

    out = []
    for key in sorted(buckets):
        ops = buckets[key]
        # classify each comm op: walk in reverse so a comm op's in-bucket
        # consumers are already classified
        status: dict[int, str] = {}
        for op in reversed(ops):
            if op.kind != "comm":
                status[id(op)] = "inline"
                continue
            if home(op, key) != key:
                status[id(op)] = "split"
                continue
            consumed_inline = any(
                status.get(cid) == "inline"
                for cid in consumers.get(op.outputs[0].name, ()))
            status[id(op)] = "inline" if consumed_inline else "split"
        out.append((key, [op for op in ops if status[id(op)] == "inline"],
                    [(op, home(op, key)) for op in ops
                     if status[id(op)] == "split"]))
    return Buckets(pipelines, n_stages, v, consumers, out)


def bucket_io(inline_ops, consumers, fetches) -> tuple[list, list]:
    """A bucket's inputs (read, not produced inside it, in first-read
    order) and outputs (fetched, or read by an op outside it)."""
    inline_ids = {id(op) for op in inline_ops}
    produced = {op.outputs[0].name for op in inline_ops}
    in_names: list[str] = []
    for op in inline_ops:
        for t in op.inputs:
            if t.name not in produced and t.name not in in_names:
                in_names.append(t.name)
    fetch_set = set(fetches)
    out_names = [
        op.outputs[0].name for op in inline_ops
        if op.outputs[0].name in fetch_set
        or (consumers.get(op.outputs[0].name, set()) - inline_ids)]
    return in_names, out_names


class TimetableRuns:
    """``run`` and ``run_schedule`` of a per-stage lowering: both walk
    ``(stage, microbatch, phase)`` ticks through the lowering's own
    ``_run(ticks, states)``; and the per-microbatch envs it packs."""

    def _make_envs(self, states) -> list[dict]:
        """One env per microbatch: placeholders packed per microbatch,
        parameters packed once and shared; a leaf that ``_leaf`` gives as
        ``None`` (a rank that holds no shard of it) is left out."""
        m = len(states)
        envs: list[dict] = [{} for _ in range(m)]
        for t in self.leaves:
            if t.name in self._per_mb and m > 1:
                xs = [self._leaf(st, t.name) for st in states]
            else:
                xs = [self._leaf(states[0], t.name)] * m
            for env, x in zip(envs, xs):
                if x is not None:
                    env[t.name] = x
        return envs

    def run(self, state: dict[str, ShardedTensor]
            ) -> dict[str, ShardedTensor]:
        """Unpipelined execution (one microbatch): dispatch the buckets
        in the canonical fwd 0..nv-1 then bwd nv-1..0 order."""
        nv = self.n_virtual
        order = [(s, 0, "fwd") for s in range(nv)] \
            + [(s, 0, "bwd") for s in reversed(range(nv))]
        return self._run(order, [state])[0]

    def run_schedule(self, schedule: PipelineSchedule, states
                     ) -> list[dict[str, ShardedTensor]]:
        """Dispatch an explicit timetable over per-microbatch states."""
        if len(states) != schedule.num_microbatches:
            raise ScheduleError(
                f"{len(states)} microbatch states for a "
                f"{schedule.num_microbatches}-microbatch schedule")
        return self._run([(t.stage, t.microbatch, t.phase)
                          for t in schedule.ticks], list(states))


class AsyncLoweredGraph(TimetableRuns, StackedGraph):
    """A deduced graph + strategy lowered to one program per (virtual
    stage, phase) bucket plus split-out comm channels on one torch
    device, dispatched over an explicit timetable.

    The graph/strategy/shape machinery of
    :class:`~repro_torch.runtime.program.LoweredGraph`, but the lowering
    re-partitions each bucket's ops separately (``partition_graph(...,
    ops=bucket)``: a whole-graph segment may span a stage/phase boundary
    with no comm op on it, e.g. the last stage's loss where fwd flows
    straight into bwd) and the explicit timetable becomes the actual
    dispatch order."""

    def __init__(self, graph: Graph, strategy: int = 0, *, device,
                 shape_env: dict[str, int] | None = None,
                 topology: Topology | None = None, fetches=None,
                 virtual_stages_per_device: int | None = None,
                 serialize: bool = False, times: RunTimes | None = None):
        super().__init__(graph, strategy, device=device,
                         shape_env=shape_env, topology=topology,
                         fetches=fetches, times=times)
        self.serialize = serialize
        b = bucket_graph(graph, strategy, self.resolved,
                         virtual_stages_per_device)
        self.pipelines, self.n_stages, self.v = b.pipelines, b.n_stages, b.v
        self.n_virtual = b.n_virtual
        self._consumers = b.consumers

        self.programs: dict[tuple[int, str], StageProgram] = {}
        self.channels: list[CommChannel] = []
        # (stage, phase) -> channels issued right after that tick
        self.triggers: dict[tuple[int, str], list[CommChannel]] = {}
        for key, inline_ops, splits in b.buckets:
            for op, trigger in splits:
                ch = self._compile_channel(op, trigger)
                self.channels.append(ch)
                self.triggers.setdefault(trigger, []).append(ch)
            prog = self._compile_bucket(key, inline_ops)
            if prog is not None:
                self.programs[key] = prog
        self._counted_ops = sum(len(p.ops)
                                for p in self.programs.values()) \
            + len(self.channels)
        self._streams: list | None = None
        #: the last run's issued stage programs, in issue order
        self.last_ticks: list[TickRecord] = []

    # -- compilation -------------------------------------------------------

    def _compile_channel(self, op, trigger) -> CommChannel:
        pl = self._lowering(op)
        return CommChannel(
            op, "reduce" if pl.has_reduce else "p2p", trigger,
            op.inputs[0].name, op.outputs[0].name, pl.apply)

    def _compile_bucket(self, key, inline_ops) -> StageProgram | None:
        if not inline_ops:
            return None
        in_names, out_names = bucket_io(inline_ops, self._consumers,
                                        self.fetches)
        if not out_names:
            return None             # dead bucket: nothing escapes

        ir = self._partition(inline_ops)
        segments = self._plan_segments(ir.segments, out_names)
        lowerings = {id(e.op): self._lowering(e.op) for e in ir.entries
                     if isinstance(e, CommSlot)}

        def fn(ins):
            tenv = dict(zip(in_names, ins))
            for entry in ir.entries:
                if isinstance(entry, CommSlot):
                    op = entry.op
                    tenv[op.outputs[0].name] = \
                        lowerings[id(op)].apply(tenv[op.inputs[0].name])
                else:
                    sr = segments.get(id(entry))
                    if sr is not None:      # dead code: nothing escapes
                        self._run_segment(sr, tenv)
            return [tenv[n] for n in out_names]

        return StageProgram(key[0], key[1], list(inline_ops), in_names,
                            out_names, fn)

    # -- introspection -----------------------------------------------------

    def describe(self) -> str:
        lines = [f"{len(self.programs)} stage program(s), "
                 f"{len(self.channels)} comm channel(s) over "
                 f"{self.n_virtual} virtual stage(s) "
                 f"(S={self.n_stages}, v={self.v})"]
        for key in sorted(self.programs):
            p = self.programs[key]
            lines.append(
                f"  [{p.phase} vstage {p.stage}] {len(p.ops)} op(s): "
                f"{len(p.in_names)} in -> {len(p.out_names)} out")
        for ch in self.channels:
            lines.append(
                f"  channel {ch.kind} {ch.in_name} -> {ch.out_name} "
                f"(after {ch.trigger[1]} vstage {ch.trigger[0]})")
        return "\n".join(lines)

    # -- pack / execute / fetch --------------------------------------------

    def _cuda_streams(self) -> list | None:
        """One stream per virtual stage, then the channels' (CUDA
        only)."""
        if self.device.type != "cuda":
            return None
        if self._streams is None:
            self._streams = [torch.cuda.Stream(self.device)
                             for _ in range(self.n_virtual + 1)]
        return self._streams

    def _issue(self, stream, fn, names, ins, ready, rec=None):
        """Run ``fn(ins)`` on ``stream`` after the events of the inputs
        made on other streams; returns its outputs and the event recorded
        after them (``None`` on the CPU)."""
        if stream is None:
            return fn(ins), None
        with torch.cuda.stream(stream):
            for name, x in zip(names, ins):
                ev, src = ready.get(name, (None, None))
                if src is not stream:
                    if ev is not None:
                        stream.wait_event(ev)
                    # keep x's memory from reuse on its own stream until
                    # the work queued here has run
                    x.record_stream(stream)
            if rec is not None:
                rec.start = torch.cuda.Event(enable_timing=True)
                rec.start.record(stream)
            outs = fn(ins)
            ev = torch.cuda.Event(enable_timing=rec is not None)
            ev.record(stream)
        if rec is not None:
            rec.end = ev
        if self.serialize:
            torch.cuda.synchronize(self.device)
        return outs, ev

    def _execute(self, ticks, envs) -> list[dict[str, ShardedTensor]]:
        """Walk ``(stage, microbatch, phase)`` ticks in order: issue the
        tick's stage program, then every channel whose input that tick
        produced; fetch a microbatch right after its last tick.  Besides
        that fetch, the loop itself waits on the host only in the
        channels' 2-slot window (some ops synchronize inside, e.g.
        ``torch_ops.add_rows_in_order``)."""
        streams = self._cuda_streams()
        if streams is not None:
            # packing and the lowerings' index tensors precede the loop
            current = torch.cuda.current_stream(self.device)
            for s in streams:
                s.wait_stream(current)
        for ch in self.channels:
            ch.inflight.clear()
        self.last_ticks = []
        # per microbatch: name -> (event, stream) of the issue that made it
        ready: list[dict] = [{} for _ in envs]
        results: list[dict | None] = [None] * len(envs)
        last = {mb: i for i, (_, mb, _) in enumerate(ticks)}
        ran = [0] * len(envs)
        t_loop = time.perf_counter()
        fetch_before = self.times.fetch
        for i, (stage, mb, phase) in enumerate(ticks):
            env, rdy = envs[mb], ready[mb]
            key = (stage, phase)
            prog = self.programs.get(key)
            if prog is not None:
                try:
                    ins = [env[n] for n in prog.in_names]
                except KeyError as e:
                    raise ScheduleError(
                        f"stage {stage} ({phase}) ran before its input "
                        f"{e} was produced (invalid schedule)") from None
                stream = streams[stage] if streams else None
                rec = TickRecord(stage, mb, phase, time.perf_counter())
                outs, ev = self._issue(stream, prog.fn, prog.in_names, ins,
                                       rdy, rec)
                rec.host_end = time.perf_counter()
                self.last_ticks.append(rec)
                env.update(zip(prog.out_names, outs))
                rdy.update(dict.fromkeys(prog.out_names, (ev, stream)))
                ran[mb] += len(prog.ops)
            for ch in self.triggers.get(key, ()):
                x = env.get(ch.in_name)
                if x is None:
                    raise ScheduleError(
                        f"stage {stage} ({phase}) ran before its input "
                        f"'{ch.in_name}' was produced (invalid "
                        f"schedule)")
                if len(ch.inflight) >= ch.slots:
                    ch.inflight.popleft().synchronize()
                stream = streams[-1] if streams else None
                (y,), ev = self._issue(stream, lambda xs, f=ch.fn: [f(xs[0])],
                                       [ch.in_name], [x], rdy)
                if ev is not None:
                    ch.inflight.append(ev)
                env[ch.out_name] = y
                rdy[ch.out_name] = (ev, stream)
                ran[mb] += 1
            if last[mb] == i:
                results[mb] = self._finish(env, rdy)
                envs[mb] = ready[mb] = None     # free the microbatch
        if any(r != self._counted_ops for r in ran):
            raise ScheduleError(
                f"schedule executed {ran} of {self._counted_ops} ops "
                f"per microbatch")
        if streams is not None:
            current = torch.cuda.current_stream(self.device)
            for s in streams:
                current.wait_stream(s)
        self.times.compute += time.perf_counter() - t_loop \
            - (self.times.fetch - fetch_before)
        return results

    def _finish(self, env, ready) -> dict[str, ShardedTensor]:
        """Wait for one microbatch's fetched tensors, then copy them."""
        for f in self.fetches:
            if f not in env:
                raise ScheduleError(
                    f"fetch {f!r} was never produced (invalid schedule)")
            # a leaf has no event: its copy is queued on the caller's
            # stream, ahead of the fetch's own
            ev = ready.get(f, (None,))[0]
            if ev is not None:
                ev.synchronize()
        return self._fetch(env)

    def _run(self, ticks, states) -> list[dict[str, ShardedTensor]]:
        self._check_tf32()
        t0 = time.perf_counter()
        envs = self._make_envs(states)
        self.times.mark("pack", t0, self.device)
        return self._execute(ticks, envs)


class AsyncExecutor:
    """MPMD per-stage dispatch on one torch device (the third executor).

    Same contract as ``SimulatorExecutor`` / ``TorchExecutor``
    (``{name: ShardedTensor}`` in, per-microbatch fetches out, bit-exact
    against both) but the explicit timetable is the actual dispatch
    order: per-stage programs issue as their inputs arrive, each virtual
    stage on its own CUDA stream, boundary P2P moves through
    double-buffered channels, and grad-reduces issue inside the backward
    wave.  ``device=None`` means ``cuda`` (raising where there is no GPU;
    TF32 is turned off).  ``serialize=True`` synchronizes the device
    after every issue (the baseline the overlap is measured against).
    ``times`` accumulates the host-clock parts of every run: ``pack``,
    ``compute`` (the dispatch loop, fetches excluded) and ``fetch``.  The
    lowered graphs are cached per (plan, fetches, v)."""

    name = "async"
    supported_schedules = SCHEDULES

    def __init__(self, device=None, *, serialize: bool = False):
        from repro_torch.device import resolve_device
        self.device = resolve_device(device)
        self.serialize = serialize
        self.times = RunTimes()
        self._cache: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()

    def lowered(self, compiled, fetches=None,
                virtual_stages_per_device: int | None = None
                ) -> AsyncLoweredGraph:
        """The (cached) per-stage lowering for this plan + fetch list."""
        per_plan = self._cache.get(compiled)
        if per_plan is None:
            per_plan = self._cache[compiled] = {}
        v = compiled.virtual_stages_per_device \
            if virtual_stages_per_device is None \
            else virtual_stages_per_device
        key = (tuple(fetches) if fetches else None, v)
        lw = per_plan.get(key)
        if lw is None:
            lw = per_plan[key] = self._lower(
                compiled, list(fetches) if fetches else None, v)
        lw.serialize = self.serialize
        return lw

    def _lower(self, compiled, fetches, v) -> AsyncLoweredGraph:
        return AsyncLoweredGraph(
            compiled.graph, compiled.strategy_index, device=self.device,
            shape_env=compiled.shape_env, topology=compiled.topology,
            fetches=fetches, virtual_stages_per_device=v, times=self.times)

    def run(self, compiled, state, fetches=None
            ) -> dict[str, ShardedTensor]:
        return self.lowered(compiled, fetches).run(state)

    def run_schedule(self, compiled, schedule: PipelineSchedule, states,
                     fetches=None) -> list[dict[str, ShardedTensor]]:
        if schedule.kind not in self.supported_schedules:
            raise ScheduleError(
                f"executor {self.name!r} does not support schedule kind "
                f"{schedule.kind!r}; supported kinds are "
                f"{', '.join(repr(s) for s in self.supported_schedules)}")
        if len(states) != schedule.num_microbatches:
            raise ScheduleError(
                f"{len(states)} microbatch states for a "
                f"{schedule.num_microbatches}-microbatch schedule")
        if schedule.n_stages != compiled.n_stages:
            raise ScheduleError(
                f"schedule has {schedule.n_stages} stage(s) but the plan "
                f"has {compiled.n_stages}")
        lw = self.lowered(compiled, fetches,
                          virtual_stages_per_device=schedule.
                          virtual_per_stage)
        return lw.run_schedule(schedule, list(states))
