"""`Session`: live sharded state + execution + dynamic strategy switching.

A Session owns the sharded weights of a Program under one active
strategy, executes steps through a pluggable
:class:`~repro_torch.api.executors.Executor`, and — the paper's §6 headline —
switches strategies *without restart*: ``session.switch(new_strategy)``
re-shards every parameter through the fused-BSR migration plan and
returns the :class:`~repro_torch.core.switching.SwitchReport` (message counts,
bytes over fast/slow links, planning + estimated transfer time).
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.schedule import (SCHEDULES, PipelineSchedule,
                                       ScheduleError, ScheduleStats,
                                       combine_outputs)
from repro_torch.core.simulator import ShardedTensor, gather, scatter
from repro_torch.core.switching import SwitchReport
from repro_torch.core.switching import switch as core_switch
from repro_torch.core.topology import Topology

from .executors import DistExecutor, Executor, TorchExecutor
from .program import CompiledPlan, Program
from .strategy import Strategy


@dataclass
class TrainResult:
    """One training step's outcome: the (global) loss, the gradient
    shards that produced the update, optimizer metrics (grad_norm, lr),
    and — for microbatched steps — the executed pipeline timetable.
    ``update_seconds`` is the host-clock time of the AdamW update, which
    runs in numpy on the host."""

    loss: float
    grads: dict[str, ShardedTensor]
    metrics: dict[str, float]
    schedule: PipelineSchedule | None = None
    outputs: dict[str, ShardedTensor] | None = None  # extra fetches
    update_seconds: float = 0.0

    @property
    def stats(self) -> "ScheduleStats | None":
        return self.schedule.stats() if self.schedule else None

    def grad_value(self, name: str) -> np.ndarray:
        """Reconstruct a parameter's global gradient."""
        return gather(self.grads[name])


@dataclass
class RunResult:
    """One step's fetched tensors, sharded per the active strategy.

    Microbatched runs also carry the pipeline ``schedule`` that was
    executed.  ``stats`` summarizes it as a
    :class:`~repro_torch.core.schedule.ScheduleStats`: tick / bubble / p2p
    counts plus the *priced* ``makespan`` and ``bubble_fraction``
    (uniform tick durations here, so makespan == slot count; re-price
    with real per-(stage, phase) costs via
    ``result.schedule.stats(durations)`` or
    ``core.schedule.price_schedule``)."""

    outputs: dict[str, ShardedTensor]
    schedule: PipelineSchedule | None = None

    @property
    def stats(self) -> "ScheduleStats | None":
        return self.schedule.stats() if self.schedule else None

    def shards(self, name: str) -> ShardedTensor:
        return self.outputs[name]

    def value(self, name: str, check_dups: bool = True) -> np.ndarray:
        """Reconstruct the global value (asserts replicas agree)."""
        return gather(self.outputs[name], check_dups=check_dups)

    def values(self) -> dict[str, np.ndarray]:
        return {name: self.value(name) for name in self.outputs}


@dataclass
class MeasuredStep:
    """A timed :meth:`Session.measure_train_step` outcome."""

    seconds: float                   # median wall time per step
    result: TrainResult              # first measured step
    # per-(stage, phase) tick timings, one {device: [per-op seconds]}
    # per executed tick, pooled across repeats (None unless the
    # executor records ticks)
    tick_device_seconds: dict[tuple[int, str],
                              list[dict[int, list[float]]]] | None = None


class Session:
    """Live sharded state for one Program, on one Executor: by default
    ``TorchExecutor()``, which runs on ``cuda`` and raises without a GPU."""

    def __init__(self, program: Program, strategy: "Strategy | str | int",
                 *, executor: Executor | None = None,
                 shape_env: dict[str, int] | None = None,
                 topology: Topology | None = None, seed: int = 0,
                 optimizer=None):
        self.program = program
        self.executor: Executor = executor or TorchExecutor()
        self.shape_env = dict(shape_env or {})
        self.topology = topology
        self.seed = seed
        self.weights: dict[str, ShardedTensor] = {}
        self.plan: CompiledPlan = program.compile(
            strategy, shape_env=self.shape_env, topology=topology)
        # training state (train_step): AdamW config + sharded m/v/count,
        # created lazily on the first step and resharded by switch()
        self.optimizer = optimizer
        self.opt_state: dict | None = None

    # -- state -------------------------------------------------------------
    @property
    def strategy(self) -> Strategy:
        return self.plan.strategy

    def _shard(self, name: str, value) -> ShardedTensor:
        if isinstance(value, ShardedTensor):
            return value
        annot = self.program.graph.tensors[name].annots[
            self.plan.strategy_index]
        return scatter(np.asarray(value), annot,
                       rng=np.random.default_rng(self.seed))

    def load(self, values: Mapping[str, object]) -> None:
        """Install parameter values (global arrays are scattered per the
        active strategy; ShardedTensors are taken as-is)."""
        params = {t.name for t in self.program.graph.parameters()}
        for name, value in values.items():
            if name not in params:
                raise ValueError(f"{name!r} is not a parameter "
                                 f"(have {sorted(params)})")
            self.weights[name] = self._shard(name, value)

    def weight_value(self, name: str) -> np.ndarray:
        return gather(self.weights[name])

    # -- execution ---------------------------------------------------------
    def run(self, feeds: Mapping[str, object] | None = None,
            fetches: Sequence[str] | None = None, *,
            num_microbatches: int = 1,
            schedule: str = "1f1b",
            virtual_stages_per_device: int | None = None) -> RunResult:
        """Execute one step: placeholders come from ``feeds`` (global
        arrays or ShardedTensors), parameters from session state.

        With ``num_microbatches=m > 1`` the step runs as a pipeline:
        batch-dim feeds are split into ``m`` microbatches, the plan's
        pipelines execute the explicit ``schedule`` ("1f1b", "gpipe" or
        "interleaved") timetable, and per-microbatch outputs are reduced
        by their microbatch role — losses/gradients (Partial) accumulate
        in microbatch order, batch-split outputs concatenate, parameters
        (Duplicate) pass through.  ``m=1`` is exactly the unpipelined
        path.

        ``schedule="interleaved"`` runs Megatron's virtual-stage 1F1B:
        each physical stage holds ``virtual_stages_per_device`` model
        chunks (default: the plan's deduced chunk count — how many times
        the strategy routes the dataflow around the device ring), the
        timetable spans ``S*v`` virtual stages, and ``m`` must be
        divisible by (or at most) the physical stage count.  Plans whose
        dataflow wraps (v > 1) can ONLY run interleaved; ``"1f1b"`` /
        ``"gpipe"`` on them raise :class:`ScheduleError`.

        The executed timetable comes back on ``RunResult.schedule``;
        ``RunResult.stats`` summarizes it (ticks, bubbles, p2p messages,
        and the priced makespan / bubble fraction — uniform tick
        durations here; pass costmodel durations to
        ``result.schedule.stats(durations)`` to price a real cluster).
        """
        feeds = dict(feeds or {})
        self._validate_schedule_kind(schedule, virtual_stages_per_device)
        if num_microbatches == 1:
            state = self._leaf_state(feeds)
            outs = self.executor.run(self.plan, state, fetches)
            return RunResult(outs)
        mplan = self.program.compile_micro(
            self.plan.strategy_index, num_microbatches,
            shape_env=self.shape_env, topology=self.topology)
        per_mb, sched = self._run_pipelined(
            mplan, feeds, fetches, schedule, virtual_stages_per_device)
        outs = self._combine(per_mb, mplan, full_plan=self.plan)
        return RunResult(outs, schedule=sched)

    def _validate_schedule_kind(self, schedule: str, v: int | None) -> None:
        """Knob validation up front — an unknown ``schedule=`` string
        fails here with the valid kinds listed, for every microbatch
        count, instead of deep inside ``build_schedule``."""
        if schedule not in SCHEDULES:
            raise ScheduleError(
                f"unknown schedule {schedule!r}; valid kinds are "
                f"{', '.join(repr(s) for s in SCHEDULES)}")
        supported = getattr(self.executor, "supported_schedules", None)
        if supported is not None and schedule not in supported:
            raise ScheduleError(
                f"executor {getattr(self.executor, 'name', '?')!r} does "
                f"not support schedule {schedule!r}; it supports "
                f"{', '.join(repr(s) for s in supported)}")
        if schedule != "interleaved" and v not in (None, 1):
            raise ScheduleError(
                f"virtual_stages_per_device={v} requires "
                f"schedule='interleaved' (got {schedule!r})")

    def _run_pipelined(self, mplan: CompiledPlan, feeds: dict, fetches,
                       schedule: str, v: int | None):
        """Shared microbatched-execution path of run/train_step: split
        feeds, build per-microbatch leaf states, execute the timetable
        on the session executor.  Returns (per-microbatch fetches,
        executed schedule)."""
        inferred = mplan.virtual_stages_per_device
        if schedule == "interleaved":
            v = inferred if v is None else v
            if v < inferred:
                raise ScheduleError(
                    f"plan interleaves {inferred} chunk(s) per device; "
                    f"virtual_stages_per_device={v} is too small")
        else:
            if inferred > 1:
                raise ScheduleError(
                    f"plan interleaves {inferred} chunks per device; "
                    f"run it with schedule='interleaved'")
            v = 1
        sched = mplan.schedule(mplan.num_microbatches, schedule,
                               virtual_stages_per_device=v)
        micro_feeds = self._split_feeds(feeds, mplan)
        states = []
        for j in range(mplan.num_microbatches):
            st: dict[str, ShardedTensor] = {}
            for t in mplan.graph.placeholders():
                annot = mplan.graph.tensors[t.name].annots[
                    mplan.strategy_index]
                st[t.name] = scatter(
                    micro_feeds[j][t.name], annot,
                    rng=np.random.default_rng(self.seed))
            for t in mplan.graph.parameters():
                if t.name not in self.weights:
                    raise ValueError(
                        f"parameter {t.name!r} not loaded; call "
                        f"session.load")
                st[t.name] = self.weights[t.name]
            states.append(st)
        if hasattr(self.executor, "run_schedule"):
            per_mb = self.executor.run_schedule(mplan, sched, states,
                                                fetches)
        else:  # third-party executors: host-level microbatch loop
            per_mb = [self.executor.run(mplan, st, fetches)
                      for st in states]
        return per_mb, sched

    def _combine(self, per_mb, mplan: CompiledPlan,
                 full_plan: CompiledPlan) -> dict[str, ShardedTensor]:
        """Reduce per-microbatch fetches by role (Partial accumulates,
        Split concatenates); full-batch shapes/annots come from the
        unmicrobatched plan over the same graph."""
        k = mplan.strategy_index
        return combine_outputs(
            per_mb, mplan.mb_roles,
            {name: full_plan.shapes[name] for name in per_mb[0]},
            {name: full_plan.graph.tensors[name].annots[k]
             for name in per_mb[0]})

    # -- training ----------------------------------------------------------
    def train_step(self, feeds: Mapping[str, object] | None = None, *,
                   num_microbatches: int = 1,
                   schedule: str = "1f1b",
                   virtual_stages_per_device: int | None = None,
                   loss: str | None = None,
                   fetches: Sequence[str] = ()) -> TrainResult:
        """One full training step on the session executor: forward ->
        backward -> gradient reduce -> AdamW, restart-free.

        The joint fwd+bwd graph (``Program.compile_train``) runs exactly
        like ``run``: unpipelined for ``num_microbatches=1``, otherwise
        as the explicit 1F1B / GPipe / interleaved timetable whose
        ``bwd`` ticks execute the real backward ExecItems; per-microbatch
        gradients carry the Partial role and accumulate bit-exactly in
        microbatch order.  Gradients arrive sharded EXACTLY like their
        parameters (the backward pass's grad-reduce comm: all-reduce for
        replicated params, reduce-scatter over the DP dim for Split
        params), so the AdamW update (``optim.adamw.sharded_apply_
        updates``) is elementwise per shard; optimizer state mirrors the
        weight sharding and is migrated by :meth:`switch`.

        ``loss`` defaults to the graph's single scalar sink; ``fetches``
        may name extra tensors (activations, activation grads via
        ``plan.grad_map``) to return on ``TrainResult.outputs``.
        """
        from repro_torch.optim.adamw import (AdamWConfig, init_sharded_state,
                                             sharded_apply_updates)

        feeds = dict(feeds or {})
        self._validate_schedule_kind(schedule, virtual_stages_per_device)
        if self.optimizer is None:
            self.optimizer = AdamWConfig()
        k = self.plan.strategy_index
        tplan = self.program.compile_train(
            k, loss=loss, num_microbatches=num_microbatches,
            shape_env=self.shape_env, topology=self.topology)
        params = [t.name for t in tplan.graph.parameters()]
        for name in params:
            if name not in self.weights:
                raise ValueError(
                    f"parameter {name!r} not loaded; call session.load")
        grad_fetch = [tplan.grad_map[p] for p in params]
        fetch_list = [tplan.loss_name] + grad_fetch + list(fetches)
        sched = None
        if num_microbatches == 1:
            state = dict(self._leaf_state(dict(feeds)))
            outs = self.executor.run(tplan, state, fetch_list)
        else:
            per_mb, sched = self._run_pipelined(
                tplan, feeds, fetch_list, schedule,
                virtual_stages_per_device)
            full = self.program.compile_train(
                k, loss=loss, shape_env=self.shape_env,
                topology=self.topology)
            outs = self._combine(per_mb, tplan, full_plan=full)
        loss_value = float(gather(outs[tplan.loss_name]))
        grads = {p: outs[g] for p, g in zip(params, grad_fetch)}
        if self.opt_state is None:
            self.opt_state = init_sharded_state(self.weights)
        t0 = time.perf_counter()
        self.weights, self.opt_state, metrics = sharded_apply_updates(
            self.weights, grads, self.opt_state, self.optimizer)
        update_seconds = time.perf_counter() - t0
        metrics["loss"] = loss_value
        extra = {f: outs[f] for f in fetches}
        return TrainResult(loss_value, grads, metrics, schedule=sched,
                           outputs=extra, update_seconds=update_seconds)

    def measure_train_step(self, feeds: Mapping[str, object] | None = None,
                           *, repeats: int = 3, warmup: int = 1,
                           **train_kw) -> "MeasuredStep":
        """Run :meth:`train_step` ``warmup + repeats`` times and report
        the median wall seconds of the measured calls, plus — when the
        executor records per-tick device timings
        (``SimulatorExecutor(record_ticks=True)``) — the per-(stage,
        phase) tick timings pooled across repeats, which the search
        validator re-prices into a parallel makespan.  Weights DO
        advance (each call is a real optimizer step); ``result`` is the
        first measured step's :class:`TrainResult`."""
        walls: list[float] = []
        ticks: dict[tuple[int, str], list[dict[int, float]]] = {}
        result: TrainResult | None = None
        for i in range(warmup + repeats):
            t0 = time.perf_counter()
            r = self.train_step(feeds, **train_kw)
            dt = time.perf_counter() - t0
            if i < warmup:
                continue
            walls.append(dt)
            if result is None:
                result = r
            rec = getattr(self.executor, "last_tick_device_seconds",
                          None)
            if rec:
                for key, occurrences in rec.items():
                    ticks.setdefault(key, []).extend(occurrences)
        assert result is not None  # repeats >= 1
        return MeasuredStep(statistics.median(walls), result,
                            ticks or None)

    def _leaf_state(self, feeds: dict) -> dict[str, ShardedTensor]:
        state: dict[str, ShardedTensor] = {}
        for t in self.program.graph.placeholders():
            if t.name not in feeds:
                raise ValueError(f"missing feed for placeholder {t.name!r}")
            state[t.name] = self._shard(t.name, feeds.pop(t.name))
        if feeds:
            raise ValueError(f"unknown feeds {sorted(feeds)}")
        for t in self.program.graph.parameters():
            if t.name not in self.weights:
                raise ValueError(
                    f"parameter {t.name!r} not loaded; call session.load")
            state[t.name] = self.weights[t.name]
        return state

    def _split_feeds(self, feeds: dict, mplan: CompiledPlan
                     ) -> list[dict[str, np.ndarray]]:
        """Split every placeholder feed along its batch dim into the
        micro plan's ``num_microbatches`` slices."""
        m = mplan.num_microbatches
        out: list[dict[str, np.ndarray]] = [{} for _ in range(m)]
        for t in self.program.graph.placeholders():
            if t.name not in feeds:
                raise ValueError(f"missing feed for placeholder {t.name!r}")
            value = feeds.pop(t.name)
            if isinstance(value, ShardedTensor):
                raise ValueError(
                    f"microbatched runs take GLOBAL arrays for feeds; "
                    f"{t.name!r} is a ShardedTensor")
            value = np.asarray(value)
            d = mplan.mb_roles[t.name]
            if value.shape[d] % m != 0:
                raise ValueError(
                    f"feed {t.name!r} batch dim {value.shape[d]} not "
                    f"divisible by {m} microbatches")
            for j, piece in enumerate(np.split(value, m, axis=d)):
                out[j][t.name] = piece
        if feeds:
            raise ValueError(f"unknown feeds {sorted(feeds)}")
        return out

    # -- dynamic switching (§6) --------------------------------------------
    def switch(self, strategy: "Strategy | str | int") -> SwitchReport:
        """Fused-BSR migration of all weights to ``strategy``; the session
        continues restart-free under the new compiled plan.

        ``strategy`` may be a Strategy object the Program has never seen
        (the elastic driver's mid-run re-selection): it is registered via
        :meth:`Program.add_strategy` first.  The returned report carries
        the measured end-to-end ``wall_seconds`` of the whole switch plus
        ``src_name``/``dst_name``.

        Weights and AdamW m/v migrate through the fused-BSR plan on the
        session's executor: a :class:`TorchExecutor` session moves them on
        its device (``backend="torch"``, the parts' times on
        ``execute_seconds``), a :class:`DistExecutor` session across its
        ranks (``backend="dist"``), any other on the numpy simulator."""
        t_wall = time.perf_counter()
        if isinstance(strategy, Strategy):
            dst = self.program.add_strategy(strategy)
        else:
            dst = self.program.index(strategy)
        src = self.plan.strategy_index
        names = self.program.names
        # validate BEFORE the same-strategy fast path: switching with
        # unloaded weights is an error regardless of the destination
        missing = [t.name for t in self.program.graph.parameters()
                   if t.name not in self.weights]
        if missing:
            raise ValueError(f"cannot switch with unloaded parameters "
                             f"{missing}")
        if dst == src:
            from repro_torch.core.bsr import BsrPlan
            return SwitchReport(plan=BsrPlan([]), planning_seconds=0.0,
                                est_transfer_seconds=0.0, total_bytes=0,
                                message_count=0,
                                wall_seconds=time.perf_counter() - t_wall,
                                src_name=names[src], dst_name=names[dst])
        # a TorchExecutor session migrates on its own device through the
        # torch comm lowering, a DistExecutor session across its ranks;
        # any other executor on the numpy simulator
        mesh = None
        if isinstance(self.executor, DistExecutor):
            backend, device = "dist", None
            mesh = self.executor.mesh
        elif isinstance(self.executor, TorchExecutor):
            backend, device = "torch", self.executor.device
        else:
            backend, device = "sim", None
        # same topology fallback as Program.compile: explicit session
        # topology first, then the destination strategy's own
        topology = self.topology or \
            self.program.strategies[dst].topology
        outcome = core_switch(
            self.weights, self.program.graph, src, dst, self.shape_env,
            topology, backend=backend, device=device, mesh=mesh)
        if self.opt_state is not None:
            # optimizer m/v mirror the weight annotations: migrate them
            # through the same fused-BSR plan so training resumes
            # restart-free after the switch
            from repro_torch.core.switching import execute_switch
            for key in ("m", "v"):
                self.opt_state[key] = execute_switch(
                    self.opt_state[key], self.program.graph, src, dst,
                    self.shape_env, topology, backend=backend, device=device,
                    mesh=mesh, report=outcome.report)
        self.weights = outcome.weights
        self.plan = self.program.compile(dst, shape_env=self.shape_env,
                                         topology=self.topology)
        outcome.report.wall_seconds = time.perf_counter() - t_wall
        outcome.report.src_name = names[src]
        outcome.report.dst_name = names[dst]
        return outcome.report
