"""Pluggable executors: run a CompiledPlan's per-device ExecItems.

The :class:`Executor` protocol is the seam between planning and
execution.  Five implementations ship (the per-stage ``AsyncExecutor``
lives in ``runtime.async_program``; :class:`DistExecutor` runs each
logical device on its own ``torch.distributed`` rank, and
:class:`DistAsyncExecutor` runs the per-stage programs there, one
pipeline stage per rank):

* :class:`SimulatorExecutor` — interprets the specialized per-device
  programs with numpy over the virtual-device simulator
  (``core.simulator``): compute ops apply the shared local semantics
  (``core.op_semantics``) shard-by-shard, CommOps run ``apply_plan``.
  Works for any device count, no accelerator needed — the executable
  specification.
* :class:`TorchExecutor` — runs the whole graph (compute AND comm) with
  every virtual device as one row of stacked buffers on one torch device
  (``runtime.program.LoweredGraph``) and caches the lowered graph per
  (plan, fetches).  Bit-exactness against the SimulatorExecutor on 2/4/8
  virtual devices is what ``tests/test_torch_executor.py`` checks.

Both take and return ``{name: ShardedTensor}`` — per-device shards under
the strategy's deduced annotations — so results are comparable
shard-by-shard, bitwise.  Output dtypes follow one shared rule
(``op_semantics.result_dtype``); bitwise parity is guaranteed for
exactly-representable computations (the differential tests' integer-
valued shards through dot/add/relu and all comm), while transcendental
kernels (gelu) may differ in the final ulp between numpy and torch.

Microbatched pipeline execution (``Session.run(num_microbatches=m)``)
goes through :meth:`run_schedule`: the SimulatorExecutor *interprets the
1F1B / GPipe / interleaved timetable tick by tick* — each forward tick
executes exactly the ops progressive specialization assigned to that
(virtual) pipeline stage, for that microbatch, so an unexecutable
schedule fails loudly — while the TorchExecutor runs the whole graph
once per microbatch (a device holding ``v`` interleaved chunks simply
belongs to the class of every one of its chunks' segments).  Both return
*per-microbatch* outputs; the Session combines them with one shared
reduction rule.
"""

from __future__ import annotations

import time
from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.op_semantics import local_apply, result_dtype, stacked_apply
from repro_torch.core.schedule import (SCHEDULES, PipelineSchedule, ScheduleError,
                                       assign_stages)
from repro_torch.core.simulator import ShardedTensor, apply_plan
from repro_torch.runtime.async_program import AsyncExecutor

from .program import CompiledPlan


@runtime_checkable
class Executor(Protocol):
    """Anything that can run a CompiledPlan over sharded state."""

    name: str

    def run(self, compiled: CompiledPlan,
            state: dict[str, ShardedTensor],
            fetches: Sequence[str] | None = None
            ) -> dict[str, ShardedTensor]:
        """Execute; ``state`` maps every leaf tensor (placeholders and
        parameters) to its ShardedTensor.  Returns the fetched tensors
        (default: graph sinks) as ShardedTensors."""
        ...

    def run_schedule(self, compiled: CompiledPlan,
                     schedule: PipelineSchedule,
                     states: Sequence[dict[str, ShardedTensor]],
                     fetches: Sequence[str] | None = None
                     ) -> list[dict[str, ShardedTensor]]:
        """Execute a microbatched pipeline schedule over the MICRO plan
        (``Program.compile_micro``); ``states[j]`` holds microbatch
        ``j``'s leaves.  Returns per-microbatch fetches, in order."""
        ...


def _check_fetches(compiled: CompiledPlan, fetches) -> list[str]:
    graph = compiled.graph
    fetches = list(fetches or [t.name for t in graph.sinks()])
    for f in fetches:  # fail up front, like LoweredGraph does
        if f not in graph.tensors:
            raise ValueError(f"unknown fetch tensor {f!r}")
    return fetches


class SimulatorExecutor:
    """Numpy interpretation of the specialized per-device programs.

    Per-op dispatch is CLASS-vectorized (the simulator mirror of the
    specialization-class lowering, ``core.lowered_ir``): devices whose
    local input/output shard shapes agree are stacked and run through
    ONE ``op_semantics.stacked_apply`` call instead of a per-device
    python loop — bit-identical per shard, since the adapters only
    re-index axes.  Kinds without a vectorized form (and singleton
    classes) fall back to the per-device ``local_apply`` path.

    ``record_ticks=True`` makes :meth:`run_schedule` keep COMPUTE
    wall-clock timings per (virtual stage, phase) tick, split BY
    DEVICE — the simulator serializes all devices onto one CPU, so its
    total wall time is pipeline-shape-blind; the per-tick max over
    devices is the parallel makespan contribution the search validator
    re-prices a timetable with (``last_tick_device_seconds``).  A
    vectorized class is timed once and the elapsed time attributed as
    ``dt / n_devices`` per device — the stacked call does each device's
    work in one batched kernel, so the per-device share is the honest
    parallel-cost proxy (this is what makes TP≥2 candidates measure
    sanely instead of paying n× python dispatch).  Comm ops are
    excluded: their simulator cost is python shard-shuffling, not
    network time."""

    name = "sim"
    #: schedule kinds run_schedule accepts (Session validates against
    #: this before building a timetable)
    supported_schedules = SCHEDULES

    def __init__(self, record_ticks: bool = False):
        self.record_ticks = record_ticks
        # (stage, phase) -> one {device: [per-op seconds]} dict per
        # executed tick; a device's op order within a (stage, phase) is
        # deterministic, so samples from different microbatches/repeats
        # align element-wise (the validator min-reduces per op)
        self.last_tick_device_seconds: dict[
            tuple[int, str], list[dict[int, list[float]]]] = {}

    def _exec_op(self, op, env: dict[str, ShardedTensor],
                 compiled: CompiledPlan, plans: dict,
                 dev_acc: dict[int, list[float]] | None = None) -> None:
        out_t = op.outputs[0]
        if op.kind == "comm":
            # never timed into dev_acc: the simulator's comm cost is
            # python shard-shuffling overhead, not network time — the
            # recorded makespan is COMPUTE-only (comm is priced
            # analytically by the cost model)
            env[out_t.name] = apply_plan(env[op.inputs[0].name],
                                         plans[id(op)])
            return
        k = compiled.strategy_index
        annot = out_t.annots[k]
        out_shape = compiled.shapes[out_t.name]
        dtype = result_dtype(op.kind,
                             [env[t.name].dtype for t in op.inputs])
        in_parts = [env[t.name].parts for t in op.inputs]
        # specialization classes, computed from the shards themselves:
        # devices with identical local input/output geometry share one
        # vectorized application (core.lowered_ir's partition would give
        # the same grouping — here the concrete shapes are already in
        # hand, so group on those)
        groups: dict[tuple, list[int]] = {}
        for dev in annot.devices:
            out_local = tuple(annot.device_shape(dev, out_shape))
            key = (tuple(tuple(p[dev].shape) for p in in_parts),
                   out_local)
            groups.setdefault(key, []).append(dev)
        parts: dict[int, np.ndarray] = {}
        for (_, out_local), devs in groups.items():
            stacked = None
            if len(devs) > 1:
                t0 = time.perf_counter() if dev_acc is not None else 0.0
                ins = [np.stack([p[d] for d in devs]) for p in in_parts]
                stacked = stacked_apply(op.kind, np, ins, op.attrs,
                                        out_local, len(devs))
                if stacked is not None:
                    stacked = np.asarray(stacked).astype(
                        dtype, copy=False)
                    dt = (time.perf_counter() - t0) / len(devs) \
                        if dev_acc is not None else 0.0
                    for j, dev in enumerate(devs):
                        parts[dev] = stacked[j].copy()
                        if dev_acc is not None:
                            dev_acc.setdefault(dev, []).append(dt)
            if stacked is None:   # singleton class or no vectorized form
                for dev in devs:
                    t0 = time.perf_counter() \
                        if dev_acc is not None else 0.0
                    locs = [p[dev] for p in in_parts]
                    parts[dev] = np.asarray(local_apply(
                        op.kind, np, locs, op.attrs, out_local)).astype(
                        dtype, copy=False)
                    if dev_acc is not None:
                        dev_acc.setdefault(dev, []).append(
                            time.perf_counter() - t0)
        env[out_t.name] = ShardedTensor(out_shape, annot, parts)

    def _leaf_env(self, compiled: CompiledPlan,
                  state: dict[str, ShardedTensor]
                  ) -> dict[str, ShardedTensor]:
        env: dict[str, ShardedTensor] = {}
        for op in compiled.graph.ops:
            if op.kind in ("placeholder", "parameter"):
                name = op.outputs[0].name
                if name not in state:
                    raise ValueError(f"missing leaf tensor {name!r}")
                env[name] = state[name]
        return env

    def run(self, compiled: CompiledPlan,
            state: dict[str, ShardedTensor],
            fetches: Sequence[str] | None = None
            ) -> dict[str, ShardedTensor]:
        fetches = _check_fetches(compiled, fetches)
        plans = {id(rc.op): rc.plan for rc in
                 compiled.specialization.resolved}
        env = self._leaf_env(compiled, state)
        for op in compiled.graph.ops:
            if op.kind not in ("placeholder", "parameter"):
                self._exec_op(op, env, compiled, plans)
        return {f: env[f] for f in fetches}

    def run_schedule(self, compiled: CompiledPlan,
                     schedule: PipelineSchedule,
                     states: Sequence[dict[str, ShardedTensor]],
                     fetches: Sequence[str] | None = None
                     ) -> list[dict[str, ShardedTensor]]:
        """Interpret the timetable: each tick runs exactly the ops of
        its (virtual) pipeline stage AND its phase for its microbatch —
        forward ticks run the forward ops, backward ticks run the
        autodiff backward ops anchored at that stage (gradient compute
        plus activation-grad / grad-reduce comm; forward-only graphs
        simply have empty bwd ticks).  Interleaved schedules index ops
        by virtual stage: chunk ``tick.stage // S`` on device
        ``tick.stage % S``.  A schedule that violates dataflow (a stage
        ticking before its producer stage) fails on the missing
        input."""
        if len(states) != schedule.num_microbatches:
            raise ScheduleError(
                f"{len(states)} microbatch states for a "
                f"{schedule.num_microbatches}-microbatch schedule")
        if schedule.n_stages != compiled.n_stages:
            raise ScheduleError(
                f"schedule has {schedule.n_stages} stage(s) but the plan "
                f"has {compiled.n_stages}")
        fetches = _check_fetches(compiled, fetches)
        graph, k = compiled.graph, compiled.strategy_index
        plans = {id(rc.op): rc.plan for rc in
                 compiled.specialization.resolved}
        # raises if the graph's chunk count exceeds the schedule's v —
        # a v>1 plan handed a plain 1F1B/GPipe table fails here loudly
        stage_of = assign_stages(
            graph, k, compiled.specialization.pipelines,
            virtual_stages_per_device=schedule.virtual_per_stage)
        ops_by_phase: dict[tuple[int, str], list] = {}
        for op in graph.ops:
            if op.kind in ("placeholder", "parameter"):
                continue
            phase = "bwd" if op.attrs.get("phase") == "bwd" else "fwd"
            ops_by_phase.setdefault(
                (stage_of[id(op)], phase), []).append(op)
        envs = [self._leaf_env(compiled, st) for st in states]
        ran = [0] * len(states)
        if self.record_ticks:
            self.last_tick_device_seconds = {}
        for tick in schedule.ticks:          # already (slot, stage) sorted
            env = envs[tick.microbatch]
            ops = ops_by_phase.get((tick.stage, tick.phase), ())
            dev_acc: dict[int, list[float]] | None = \
                {} if (self.record_ticks and ops) else None
            for op in ops:
                try:
                    self._exec_op(op, env, compiled, plans, dev_acc)
                except KeyError as e:
                    raise ScheduleError(
                        f"stage {tick.stage} ({tick.phase}) ran before "
                        f"its input {e} was produced (invalid "
                        f"schedule)") from None
                ran[tick.microbatch] += 1
            if dev_acc is not None:
                self.last_tick_device_seconds.setdefault(
                    (tick.stage, tick.phase), []).append(dev_acc)
        n_ops = sum(len(v) for v in ops_by_phase.values())
        if any(r != n_ops for r in ran):
            raise ScheduleError(
                f"schedule executed {ran} of {n_ops} ops per microbatch")
        return [{f: env[f] for f in fetches} for env in envs]


class TorchExecutor:
    """Execution on one torch device: every virtual device is one row of
    stacked buffers (``runtime.program.LoweredGraph``), so a virtual mesh
    of any size runs on one GPU, or on the CPU when ``device="cpu"``.
    ``device=None`` means ``cuda`` (raising where there is no GPU; TF32
    is turned off).  The lowered graph is cached per (plan, fetches,
    microbatch count).

    ``times`` accumulates the host-clock parts of every run (packing and
    copying leaves to the device, compute, comm, fetching).  B1's
    launches are counted where they happen, in the kernel wrapper
    (``kernels.flash_attention.launches``); the lowered graph's
    ``stats.kernel_dispatches`` says how many a run should make."""

    name = "torch"
    supported_schedules = SCHEDULES

    def __init__(self, device=None):
        import weakref

        from repro_torch.device import resolve_device
        from repro_torch.runtime.program import RunTimes
        self.device = resolve_device(device)
        self.times = RunTimes()
        # keyed by the CompiledPlan object itself (weakly, so dropped
        # plans evict their lowered graphs and dead ids can't alias)
        self._cache: "weakref.WeakKeyDictionary[CompiledPlan, dict]" = \
            weakref.WeakKeyDictionary()

    def _lower(self, compiled: CompiledPlan, fetches: list[str] | None,
               num_microbatches: int):
        from repro_torch.runtime.program import LoweredGraph
        return LoweredGraph(compiled.graph, compiled.strategy_index,
                            device=self.device,
                            shape_env=compiled.shape_env,
                            topology=compiled.topology, fetches=fetches,
                            num_microbatches=num_microbatches,
                            times=self.times)

    def lowered(self, compiled: CompiledPlan,
                fetches: Sequence[str] | None = None,
                num_microbatches: int = 1):
        """The (cached) lowered graph for this plan + fetch list."""
        per_plan = self._cache.get(compiled)
        if per_plan is None:
            per_plan = self._cache[compiled] = {}
        key = (tuple(fetches) if fetches else None, num_microbatches)
        lw = per_plan.get(key)
        if lw is None:
            lw = per_plan[key] = self._lower(
                compiled, list(fetches) if fetches else None,
                num_microbatches)
        return lw

    def run(self, compiled: CompiledPlan,
            state: dict[str, ShardedTensor],
            fetches: Sequence[str] | None = None
            ) -> dict[str, ShardedTensor]:
        return self.lowered(compiled, fetches).run(state)

    def run_schedule(self, compiled: CompiledPlan,
                     schedule: PipelineSchedule,
                     states: Sequence[dict[str, ShardedTensor]],
                     fetches: Sequence[str] | None = None
                     ) -> list[dict[str, ShardedTensor]]:
        """All microbatches through the same lowered graph, one after the
        other.  The explicit timetable is the simulator's contract; the
        microbatches are independent until the Session combines their
        outputs, so running them in order gives the same per-microbatch
        results, and the schedule only sizes the run here."""
        if len(states) != schedule.num_microbatches:
            raise ScheduleError(
                f"{len(states)} microbatch states for a "
                f"{schedule.num_microbatches}-microbatch schedule")
        lw = self.lowered(compiled, fetches,
                          num_microbatches=len(states))
        return lw.run_microbatches(list(states))


class DistExecutor(TorchExecutor):
    """Execution across ``torch.distributed`` ranks, each logical device on
    its own rank (``runtime.dist_program.RankLoweredGraph``): the
    counterpart of the reference's ``JaxExecutor``.  Every rank runs the
    same ``Session`` from the same seed and calls :meth:`run` with the
    same state; each rank computes and moves only its own shards, and
    every rank gets every fetched shard back, so the Session's host state
    (weights, AdamW m and v) stays identical on every rank.

    ``mesh`` is a ``launch.mesh.RankMesh``; ``None`` makes one over the
    world group (``make_runtime_mesh(device=device)``), initializing it
    from the environment ``runtime.harness.run_ranks`` gives each rank.
    ``device=None`` means ``cuda``, raising where there is no GPU; with a
    mesh given, the device is the mesh's.  Comm ops reduce exactly (the
    simulator's float64 fold in ``srcs`` order).  Caching, :meth:`run`
    and :meth:`run_schedule` are ``TorchExecutor``'s; every rank must
    ask for the same lowered graphs in the same order (comm plans make
    their subgroups when lowered).  ``times`` accumulates the host-clock
    parts of every run (``RankRunTimes``)."""

    name = "dist"

    def __init__(self, mesh=None, *, device=None):
        from repro_torch.runtime.dist_program import RankRunTimes
        mesh = _rank_mesh(mesh, device)
        super().__init__(mesh.device)
        self.mesh = mesh
        self.times = RankRunTimes()
        # the traffic counters of every graph lowered here (its comm
        # plans' and its fetch's), kept past the graph's eviction
        self._traffic: list = []

    def _lower(self, compiled: CompiledPlan, fetches: list[str] | None,
               num_microbatches: int):
        from repro_torch.runtime.dist_program import RankLoweredGraph
        lw = RankLoweredGraph(compiled.graph, compiled.strategy_index,
                              mesh=self.mesh, shape_env=compiled.shape_env,
                              topology=compiled.topology, fetches=fetches,
                              num_microbatches=num_microbatches,
                              times=self.times)
        self._traffic += lw.traffic_counters()
        return lw

    def traffic(self):
        """This rank's traffic over every run so far (``LoweringStats``:
        point-to-point messages and bytes, collectives, bytes staged),
        the comm plans' and the fetches' together."""
        return _traffic_total(self._traffic)


class DistAsyncExecutor(AsyncExecutor):
    """Async MPMD execution across ``torch.distributed`` ranks, one
    pipeline stage per rank (``runtime.dist_async_program.
    RankAsyncLoweredGraph``): each rank issues only its own stages'
    programs over the explicit timetable, and the stage-boundary values
    move through double-buffered point-to-point channels, the gradient
    reduces through subgroup collectives.  Every rank runs the same
    ``Session`` with the same state, as on :class:`DistExecutor`, and gets
    every fetched shard back.

    The mesh and the device are :class:`DistExecutor`'s (``mesh=None``
    makes one over the world, ``device=None`` means ``cuda``); the cache
    (per plan, fetches and v), :meth:`run` and :meth:`run_schedule` are
    :class:`AsyncExecutor`'s; ``serialize=True`` completes every channel
    as it is posted and synchronizes the device after every tick.
    ``Session.switch`` on this executor migrates on the numpy simulator,
    as the reference's does for its ``AsyncExecutor``; every rank computes
    the same migration, so every rank's state stays identical."""

    name = "dist-async"

    def __init__(self, mesh=None, *, device=None, serialize: bool = False):
        from repro_torch.runtime.dist_program import RankRunTimes
        mesh = _rank_mesh(mesh, device)
        super().__init__(mesh.device, serialize=serialize)
        self.mesh = mesh
        self.times = RankRunTimes()
        self._traffic: list = []

    def _lower(self, compiled, fetches, v):
        from repro_torch.runtime.dist_async_program import \
            RankAsyncLoweredGraph
        lw = RankAsyncLoweredGraph(
            compiled.graph, compiled.strategy_index, mesh=self.mesh,
            shape_env=compiled.shape_env, topology=compiled.topology,
            fetches=fetches, virtual_stages_per_device=v, times=self.times)
        self._traffic += lw.traffic_counters()
        return lw

    def traffic(self):
        """This rank's traffic over every run so far, as
        :meth:`DistExecutor.traffic` counts it."""
        return _traffic_total(self._traffic)


def _rank_mesh(mesh, device):
    """The rank executors' mesh: ``mesh``, checked against ``device``, or
    one over the world group (``make_runtime_mesh(device=device)``)."""
    import torch
    if mesh is None:
        from repro_torch.device import resolve_device
        from repro_torch.launch.mesh import make_runtime_mesh
        resolve_device(device)       # no GPU and no "cpu": raise first
        return make_runtime_mesh(device=device)
    if device is not None and mesh.device.type != torch.device(device).type:
        raise ValueError(f"device {device!r} disagrees with the mesh's "
                         f"{mesh.device}")
    return mesh


def _traffic_total(counters):
    """The point-to-point messages and bytes, collectives and staged bytes
    of ``counters`` (``LoweringStats``), summed."""
    from repro_torch.runtime.lowering import LoweringStats
    total = LoweringStats()
    for stats in counters:
        for name in ("p2p_messages", "p2p_bytes", "collectives",
                     "staged_bytes"):
            setattr(total, name, getattr(total, name) + getattr(stats, name))
    return total


def _executor_registry() -> dict:
    return {"sim": SimulatorExecutor, "torch": TorchExecutor,
            "async": AsyncExecutor, "dist": DistExecutor,
            "dist-async": DistAsyncExecutor}


def get_executor(name: str, **kwargs) -> Executor:
    """Executor registry: ``"sim"``, ``"torch"``, ``"async"``, ``"dist"``
    or ``"dist-async"`` (the string form used by CLI flags).  Unknown
    names raise ``ValueError`` listing the valid options; unknown options
    raise ``TypeError`` instead of vanishing silently."""
    registry = _executor_registry()
    cls = registry.get(name)
    if cls is None:
        raise ValueError(
            f"unknown executor {name!r} "
            f"(have: {', '.join(sorted(registry))})")
    return cls(**kwargs)  # unknown kwargs raise TypeError
