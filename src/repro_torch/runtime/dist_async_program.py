"""Async MPMD execution across ranks: one pipeline stage per rank, with
double-buffered point-to-point channels between them.

The rank path's counterpart of ``runtime/async_program.py:
AsyncLoweredGraph`` (and of the reference's ``repro/runtime/
async_program.py``).  The graph's ops are bucketed by ``(virtual stage,
phase)`` and their comm ops split into channels by the same code
(``async_program.bucket_graph``); what differs is where a bucket runs:

* **per-rank programs**: a rank compiles a program only for the buckets
  its device takes part in: it runs its own class of a live segment of
  the bucket, or its plan of an inline comm op (``RankPlanLowering.
  involved``).  A program runs this rank's class of each segment over a
  row of one through ``program.run_class`` and the inline comm ops
  through their ``RankPlanLowering``, as ``dist_program.RankLoweredGraph``
  runs the whole graph.  A device of the interleaved zigzag holds two
  virtual stages, so it has two programs for each phase,
* **channels**: each channel's plan is a ``RankPlanLowering``.  Every comm
  op is lowered on every rank, in graph order, because ``dist.new_group``
  is collective over the world.  At the tick that triggers a channel, every
  rank posts its part (``RankPlanLowering.post``: a sender's ``isend``\\ s,
  a receiver's ``irecv``\\ s, each returning at once; a grad-reduce
  channel's subgroup collectives run to their end there); a receiver
  completes the receive when a tick of its own, or the microbatch's fetch,
  needs the value.  Each channel keeps the one-device path's 2-slot
  window: a third post on a channel first completes its oldest
  outstanding one,
* **fetch**: each microbatch's fetch (``dist_lowering.gather_shards``,
  collective over the world) runs on every rank at the microbatch's last
  tick, so every rank returns every fetched shard.

**Why nothing deadlocks.**  Every rank walks the *whole* timetable in the
same global order: at each tick it runs the tick's program if the bucket
is its own, then posts every channel that tick triggers, then, at a
microbatch's last tick, joins its fetch.  So every rank posts its part of
every exchange, and joins every collective, at the same position of one
global order, and any two ranks post their messages to each other in the
same order (gloo matches a pair's point-to-point messages in posting
order).  A rank waits only (a) inside a collective, for the members that
join it at the same position, or (b) on an exchange posted at a position
no later than its own.  Suppose some rank waited forever, and take the
earliest position ``p`` at which one does.  Every partner it waits on has
reached its matching post at ``p`` or before it, since a partner stuck
earlier would contradict ``p`` being the earliest; so the partner has
posted the matching send or receive, or joined the collective, and the
wait ends.  By induction over the global order, no wait is forever.  A
rank with no stage in a strategy still builds every lowering, posts
every channel (doing nothing for one that does not involve it) and joins
every fetch.

Each rank issues on its device's current stream: a rank runs one stage
(two under v=2), so the stacked path's stream per virtual stage has
nothing to overlap here; the stages overlap because they are processes.
Under gloo a CUDA payload is staged through host memory when it is
posted (``RankPlanLowering._out``), which waits for the stream that made
it; the staged bytes are counted in the lowerings' ``stats``.

``serialize=True`` completes every channel right after it is posted and
synchronizes the device after every tick's program: the baseline the
overlap is measured against.  Both orders give the same bits.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from repro_torch.core.graph import Graph
from repro_torch.core.lowered_ir import CommSlot
from repro_torch.core.schedule import ScheduleError
from repro_torch.core.simulator import ShardedTensor
from repro_torch.core.topology import Topology

from .async_program import (CommChannel, StageProgram, TickRecord,
                            TimetableRuns, bucket_graph, bucket_io)
from .dist_program import RankGraph, RankRunTimes


class RankAsyncLoweredGraph(TimetableRuns, RankGraph):
    """A deduced graph + strategy lowered onto this rank as one program
    per (virtual stage, phase) bucket its device runs, plus every split
    comm op as a channel, dispatched over an explicit timetable that every
    rank walks in the same order.

    ``buckets`` holds every live bucket's inputs, outputs and ops (the
    same on every rank; ``fn`` is ``None`` where this rank does not run
    the bucket), ``programs`` this rank's.  ``times`` (``RankRunTimes``)
    gets ``pack``; ``comm`` (posting and completing channels and the
    inline comm ops), of which ``staging``; ``fetch``; and ``compute``, the
    dispatch loop less its comm and fetch, so that the loop is compute +
    comm as on ``RankLoweredGraph``.  ``last_ticks`` holds this rank's
    ticks of the last run, with CUDA events on the card."""

    def __init__(self, graph: Graph, strategy: int = 0, *, mesh,
                 shape_env: dict[str, int] | None = None,
                 topology: Topology | None = None, fetches=None,
                 virtual_stages_per_device: int | None = None,
                 serialize: bool = False,
                 times: RankRunTimes | None = None):
        super().__init__(graph, strategy, mesh=mesh, shape_env=shape_env,
                         topology=topology, fetches=fetches, times=times)
        self.serialize = serialize
        b = bucket_graph(graph, strategy, self.resolved,
                         virtual_stages_per_device)
        self.pipelines, self.n_stages, self.v = b.pipelines, b.n_stages, b.v
        self.n_virtual = b.n_virtual
        self.buckets: dict[tuple[int, str], StageProgram] = {}
        self.programs: dict[tuple[int, str], StageProgram] = {}
        self.channels: list[CommChannel] = []
        # (stage, phase) -> channels posted right after that tick
        self.triggers: dict[tuple[int, str], list[CommChannel]] = {}
        for key, inline_ops, splits in b.buckets:
            for op, trigger in splits:
                lw = self._lowerings[id(op)]
                ch = CommChannel(op, "reduce" if lw.has_reduce else "p2p",
                                 trigger, op.inputs[0].name,
                                 op.outputs[0].name, lw)
                self.channels.append(ch)
                self.triggers.setdefault(trigger, []).append(ch)
            prog = self._compile_bucket(key, inline_ops, b.consumers)
            if prog is not None:
                self.buckets[key] = prog
                if prog.fn is not None:
                    self.programs[key] = prog
        self._counted_ops = sum(len(p.ops) for p in self.buckets.values()) \
            + len(self.channels)
        #: this rank's issued stage programs of the last run, in order
        self.last_ticks: list[TickRecord] = []

    def _compile_bucket(self, key, inline_ops, consumers
                        ) -> StageProgram | None:
        if not inline_ops:
            return None
        in_names, out_names = bucket_io(inline_ops, consumers, self.fetches)
        if not out_names:
            return None             # dead bucket: nothing escapes
        ir = self._partition(inline_ops)
        runs = self._rank_segments(ir.segments, out_names)
        mine = bool(runs) or any(self._lowerings[id(e.op)].involved
                                 for e in ir.entries
                                 if isinstance(e, CommSlot))
        fn = None
        if mine:
            def fn(ins):
                tenv = {n: x for n, x in zip(in_names, ins) if x is not None}
                self._run_entries(ir.entries, runs, tenv)
                return [tenv.get(n) for n in out_names]
        return StageProgram(key[0], key[1], list(inline_ops), in_names,
                            out_names, fn)

    # -- pack / execute / fetch --------------------------------------------

    def _settle(self, envs, pending, entry) -> None:
        """Complete one posted channel ``(microbatch, name, PendingPlan)``
        and put what this rank receives into its microbatch's env."""
        mb, name, p = entry
        if p.done:
            return
        t0 = time.perf_counter()
        y = p.complete(self.times)
        self.times.mark("comm", t0, self.device)
        if pending[mb].get(name) is entry:
            del pending[mb][name]
        if y is not None and envs[mb] is not None:
            envs[mb][name] = y.unsqueeze(0)

    def _take(self, envs, pending, mb, name):
        """This rank's value of ``name`` in microbatch ``mb`` (a row of
        one, or ``None`` where it holds none), completing the channel that
        delivers it first."""
        entry = pending[mb].get(name)
        if entry is not None:
            self._settle(envs, pending, entry)
        return envs[mb].get(name)

    def _issue(self, prog, mb, ins):
        rec = TickRecord(prog.stage, mb, prog.phase, time.perf_counter())
        cuda = self.device.type == "cuda"
        if cuda:
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.start.record()
        outs = prog.fn(ins)
        if cuda:
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.end.record()
            if self.serialize:
                torch.cuda.synchronize(self.device)
        rec.host_end = time.perf_counter()
        self.last_ticks.append(rec)
        return outs

    def _execute(self, ticks, envs) -> list[dict[str, ShardedTensor]]:
        """Walk every ``(stage, microbatch, phase)`` tick in order on every
        rank: run the tick's program where it is this rank's, post every
        channel the tick triggers, and fetch a microbatch at its last
        tick.  Whether an input was produced is known on every rank, so a
        tick that runs too early raises ``ScheduleError`` on every rank."""
        m = len(envs)
        made = [{t.name for t in self.leaves} for _ in range(m)]
        pending: list[dict] = [{} for _ in range(m)]
        for ch in self.channels:
            ch.inflight.clear()
        self.last_ticks = []
        results: list[dict | None] = [None] * m
        last = {mb: i for i, (_, mb, _) in enumerate(ticks)}
        ran = [0] * m
        t_loop = time.perf_counter()
        fetch0, comm0, compute0 = (self.times.fetch, self.times.comm,
                                   self.times.compute)
        try:
            for i, (stage, mb, phase) in enumerate(ticks):
                ran[mb] += self._tick(stage, mb, phase, envs, made[mb],
                                      pending)
                if last[mb] == i:
                    for f in self.fetches:
                        if f not in made[mb]:
                            raise ScheduleError(
                                f"fetch {f!r} was never produced (invalid "
                                f"schedule)")
                        self._take(envs, pending, mb, f)
                    results[mb] = self._fetch(envs[mb])
                    envs[mb] = None         # free the microbatch
        finally:
            # the senders' last transfers; after an error that every rank
            # raises at the same tick (an invalid timetable), what was
            # posted is completed too, so that no stale message meets the
            # next run's receives
            for ch in self.channels:
                while ch.inflight:
                    self._settle(envs, pending, ch.inflight.popleft())
        if any(r != self._counted_ops for r in ran):
            raise ScheduleError(
                f"schedule executed {ran} of {self._counted_ops} ops "
                f"per microbatch")
        t = self.times
        t.compute = compute0 + time.perf_counter() - t_loop \
            - (t.fetch - fetch0) - (t.comm - comm0)
        return results

    def _tick(self, stage, mb, phase, envs, made, pending) -> int:
        """One tick on this rank: its program where the bucket is this
        rank's, then its part of every channel the tick triggers; returns
        the ops the tick accounts for (on every rank)."""
        key = (stage, phase)
        ran = 0
        prog = self.buckets.get(key)
        if prog is not None:
            for n in prog.in_names:
                if n not in made:
                    raise ScheduleError(
                        f"stage {stage} ({phase}) ran before its input "
                        f"'{n}' was produced (invalid schedule)")
            if prog.fn is not None:
                outs = self._issue(prog, mb, [
                    self._take(envs, pending, mb, n) for n in prog.in_names])
                envs[mb].update((n, y) for n, y in zip(prog.out_names, outs)
                                if y is not None)
            made.update(prog.out_names)
            ran += len(prog.ops)
        for ch in self.triggers.get(key, ()):
            if ch.in_name not in made:
                raise ScheduleError(
                    f"stage {stage} ({phase}) ran before its input "
                    f"'{ch.in_name}' was produced (invalid schedule)")
            x = self._take(envs, pending, mb, ch.in_name)
            ch.inflight = deque(e for e in ch.inflight if not e[2].done)
            if len(ch.inflight) >= ch.slots:
                self._settle(envs, pending, ch.inflight.popleft())
            t0 = time.perf_counter()
            entry = (mb, ch.out_name, ch.fn.post(
                None if x is None else x[0], self._tdtype(ch.in_name),
                times=self.times))
            self.times.mark("comm", t0, self.device)
            pending[mb][ch.out_name] = entry
            if self.serialize:
                self._settle(envs, pending, entry)
            else:
                ch.inflight.append(entry)
            made.add(ch.out_name)
            ran += 1
        return ran

    def _run(self, ticks, states) -> list[dict[str, ShardedTensor]]:
        self._check_tf32()
        self._check_dtypes(states[0])
        t0 = time.perf_counter()
        envs = self._make_envs(states)
        self.times.mark("pack", t0, self.device)
        return self._execute(ticks, envs)
