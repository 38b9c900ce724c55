"""`Program`: one single-device graph + N strategies, compiled per strategy.

``program.compile(strategy)`` runs the paper's full front half —
annotation deduction (§5.2), hierarchical communication resolution (§4),
progressive per-device specialization and pipeline construction
(§5.3-5.4) — and returns a :class:`CompiledPlan`: per-device ExecItems,
resolved comm plans, pipelines, and an analytic cost/roofline estimate.
A CompiledPlan is inert data; executing it is an
:class:`~repro_torch.api.executors.Executor`'s job.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.core import op_semantics
from repro_torch.core.graph import DeductionReport, GradError, Graph
from repro_torch.core.plan import CommPlan
from repro_torch.core.schedule import (PipelineSchedule, build_schedule,
                                       infer_virtual_stages, microbatch_graph,
                                       microbatch_roles)
from repro_torch.core.specialize import (ExecItem, ExecutableGraph,
                                         SpecializationResult, specialize_all)
from repro_torch.core.symbolic import bind_shape, free_symbols
from repro_torch.core.topology import Topology, UniformTopology

from .strategy import Strategy, StrategyError


class CompileError(ValueError):
    pass


# stable default so memoized compiles keyed on topology identity can hit
_DEFAULT_TOPOLOGY = UniformTopology()


@dataclass(frozen=True)
class CostEstimate:
    """Analytic cost terms of one compiled strategy (roofline inputs)."""

    flops: int                      # global compute work
    comm_bytes: int                 # bytes crossing device boundaries
    comm_messages: int              # collective / p2p launches
    est_comm_seconds: float         # priced on the strategy topology
    per_kind_bytes: dict[str, int] = field(default_factory=dict)

    def roofline_seconds(self, peak_flops: float) -> float:
        """max(compute, comm) completion-time proxy at ``peak_flops``."""
        return max(self.flops / max(peak_flops, 1.0),
                   self.est_comm_seconds)

    def summary(self) -> str:
        kinds = ",".join(f"{k}:{v / 1e6:.2f}MB"
                         for k, v in sorted(self.per_kind_bytes.items()))
        return (f"{self.flops / 1e6:.2f} MFLOP, "
                f"{self.comm_bytes / 1e6:.2f} MB comm in "
                f"{self.comm_messages} msgs "
                f"(~{self.est_comm_seconds * 1e3:.2f} ms) [{kinds}]")


@dataclass(eq=False)  # identity semantics: executors cache per plan object
class CompiledPlan:
    """Result of ``Program.compile``: everything an Executor needs."""

    graph: Graph
    strategy: Strategy
    strategy_index: int
    shapes: dict[str, tuple[int, ...]]
    shape_env: dict[str, int]
    topology: Topology
    specialization: SpecializationResult
    cost: CostEstimate
    # set on micro-plans (Program.compile_micro): how many microbatches the
    # shapes were scaled down by, and each tensor's microbatch role
    num_microbatches: int = 1
    mb_roles: dict[str, int] | None = None
    # set on TRAIN plans (Program.compile_train): autodiff provenance —
    # forward tensor name -> gradient tensor name, and the loss tensor
    grad_map: dict[str, str] | None = None
    loss_name: str | None = None
    _schedules: dict = field(default_factory=dict, repr=False)
    _n_virtual: int | None = field(default=None, repr=False)

    @property
    def devices(self) -> tuple[int, ...]:
        return self.specialization.devices

    @property
    def n_stages(self) -> int:
        """PHYSICAL pipeline depth of this strategy (1 when nothing is
        staged); with interleaving each physical stage holds
        ``virtual_stages_per_device`` model chunks."""
        return max((len(p.stages)
                    for p in self.specialization.pipelines), default=1)

    @property
    def virtual_stages_per_device(self) -> int:
        """Megatron's ``v``: how many model chunks this graph's dataflow
        places on each physical stage (1 unless the strategy routes the
        graph around the device ring more than once — such plans can
        only be scheduled with ``schedule="interleaved"``)."""
        if self._n_virtual is None:
            self._n_virtual = infer_virtual_stages(
                self.graph, self.strategy_index,
                self.specialization.pipelines)
        return self._n_virtual

    def schedule(self, num_microbatches: int, kind: str = "1f1b",
                 virtual_stages_per_device: int | None = None
                 ) -> PipelineSchedule:
        """The explicit (slot, stage, microbatch, phase) timetable this
        plan's pipelines follow for ``num_microbatches`` (memoized).
        ``kind="interleaved"`` defaults ``virtual_stages_per_device`` to
        the plan's deduced chunk count; other kinds require v=1."""
        v = virtual_stages_per_device
        if v is None:
            v = self.virtual_stages_per_device if kind == "interleaved" \
                else 1
        key = (num_microbatches, kind, v)
        cached = self._schedules.get(key)
        if cached is None:
            cached = self._schedules[key] = build_schedule(
                self.n_stages, num_microbatches, kind,
                virtual_stages_per_device=v)
        return cached

    def tick_durations(self, flops_per_second: float = 1e12,
                       virtual_stages_per_device: int | None = None
                       ) -> dict[tuple[int, str], float]:
        """MEASURED per-(virtual stage, phase) tick durations from this
        plan's own graph: each (chunk, phase) slot is priced by the real
        FLOPs of the ops assigned to it (autodiff backward ops fill the
        ``bwd`` slots of a train plan; forward-only plans price bwd as
        0).  Feed to ``schedule.stats(durations)`` /
        ``core.schedule.price_schedule`` to re-time a timetable — the
        measured replacement for the cost model's fwd:bwd = 1:2
        assumption."""
        from repro_torch.core.costmodel import graph_tick_durations
        v = virtual_stages_per_device or self.virtual_stages_per_device
        return graph_tick_durations(
            self.graph, self.strategy_index,
            self.specialization.pipelines, v, self.shapes,
            flops_per_second)

    def fwd_fraction(self) -> float:
        """The fwd share of this plan's compute FLOPs
        (:func:`~repro_torch.core.costmodel.measured_fwd_fraction`; the
        analytic 1/3 for forward-only plans)."""
        from repro_torch.core.costmodel import measured_fwd_fraction
        return measured_fwd_fraction(
            self.graph, self.strategy_index,
            self.specialization.pipelines,
            self.virtual_stages_per_device, self.shapes)

    def predicted_step_seconds(self, num_microbatches: int,
                               kind: str = "1f1b", *,
                               flops_per_second: float = 1e12,
                               virtual_stages_per_device: int | None = None
                               ) -> float:
        """Makespan of this plan's own timetable under its MEASURED
        per-tick durations: ``schedule(m).stats(tick_durations())`` — the
        plan-level prediction the search subsystem compares against
        executed step times (scale-free up to ``flops_per_second``)."""
        v = virtual_stages_per_device
        if v is None:
            v = self.virtual_stages_per_device if kind == "interleaved" \
                else 1
        sched = self.schedule(num_microbatches, kind,
                              virtual_stages_per_device=v)
        durations = self.tick_durations(flops_per_second,
                                        virtual_stages_per_device=v)
        return sched.stats(durations).makespan

    @property
    def comm_plans(self) -> list[CommPlan]:
        return [rc.plan for rc in self.specialization.resolved]

    def exec_items(self, device: int) -> list[ExecItem]:
        """This device's executable graph (paper Fig 9)."""
        return self.specialization.exec_graphs[device].items

    def exec_graph(self, device: int) -> ExecutableGraph:
        return self.specialization.exec_graphs[device]

    def describe(self) -> str:
        lines = [f"CompiledPlan[{self.strategy.name}] over "
                 f"{len(self.devices)} device(s), "
                 f"{len(self.specialization.pipelines)} pipeline(s)"]
        for p in self.specialization.pipelines:
            lines.append("  pipeline: " + " -> ".join(
                str(sorted(s)) for s in p.stages))
        for rc in self.specialization.resolved:
            lines.append(f"  comm {rc.op.outputs[0].name}: {rc.plan.kind}")
        lines.append("  cost: " + self.cost.summary())
        return "\n".join(lines)


def _estimate_cost(graph: Graph, shapes, resolved,
                   topology: Topology) -> CostEstimate:
    flops = 0
    for op in graph.ops:
        if op.kind in ("placeholder", "parameter", "comm"):
            continue
        flops += op_semantics.flops(
            op.kind, [shapes[t.name] for t in op.inputs],
            shapes[op.outputs[0].name], op.attrs)
    comm_bytes = 0
    messages = 0
    est_s = 0.0
    per_kind: dict[str, int] = {}
    for rc in resolved:
        plan = rc.plan
        comm_bytes += plan.nbytes_moved()
        messages += plan.message_count()
        for step in plan.steps:
            nb = step.nbytes_moved()
            per_kind[step.kind] = per_kind.get(step.kind, 0) + nb
            for g in step.groups:
                worst = max((topology.time_for(s, d, nb)
                             for s in g.srcs for d in g.dsts if s != d),
                            default=0.0)
                est_s += worst / max(len(step.groups), 1)
    return CostEstimate(flops, comm_bytes, messages, est_s, per_kind)


class Program:
    """A single-device graph bound to N named strategies."""

    def __init__(self, graph: Graph, strategies: Sequence[Strategy]):
        import copy
        if not strategies:
            raise StrategyError("Program needs at least one strategy")
        names = [s.name for s in strategies]
        if len(set(names)) != len(names):
            raise StrategyError(f"duplicate strategy names in {names}")
        for s in strategies:
            s.validate_against(graph)
        # own a private copy: installing annotations must not corrupt a
        # graph another Program (and its live Sessions) already wraps
        self.graph = copy.deepcopy(graph)
        self.strategies = list(strategies)
        points = set()
        for t in self.graph.annotation_points():
            t.annots = [s.annots[t.name] for s in strategies]
            points.add(id(t))
        for t in self.graph.tensors.values():
            if id(t) not in points:
                # stale deduced annots from a prior deduce() would skew
                # deduce's strategy count; they are recomputed anyway
                t.annots = []
        self.report: DeductionReport = self.graph.deduction_report()
        self._compile_cache: dict[tuple, CompiledPlan] = {}
        self._joint_cache: dict[str, Graph] = {}

    @classmethod
    def from_annotated(cls, graph: Graph,
                       names: Sequence[str] | None = None) -> "Program":
        """Wrap a graph whose leaves already carry (multi-)annotations —
        the pre-API construction style, kept importable as a shim."""
        import copy
        graph = copy.deepcopy(graph)
        report = graph.deduction_report()  # deduces (once)
        points = graph.annotation_points()
        n = report.n_strategies
        names = list(names or (f"s{i}" for i in range(n)))
        if len(names) != n:
            raise StrategyError(
                f"{len(names)} names for {n} annotation strategies")
        if len(set(names)) != len(names):
            raise StrategyError(f"duplicate strategy names in {names}")
        strategies = [
            Strategy(names[k], {t.name: t.annots[k] for t in points})
            for k in range(n)]
        prog = cls.__new__(cls)
        prog.graph = graph
        prog.strategies = strategies
        prog.report = report
        prog._compile_cache = {}
        prog._joint_cache = {}
        return prog

    # -- lookup ------------------------------------------------------------
    @property
    def names(self) -> list[str]:
        return [s.name for s in self.strategies]

    def index(self, strategy: "Strategy | str | int") -> int:
        if isinstance(strategy, int):
            if not 0 <= strategy < len(self.strategies):
                raise StrategyError(f"strategy index {strategy} out of "
                                    f"range; have {self.names}")
            return strategy
        name = strategy.name if isinstance(strategy, Strategy) else strategy
        for i, s in enumerate(self.strategies):
            if s.name == name:
                return i
        raise StrategyError(f"unknown strategy {name!r}; have {self.names}")

    def strategy(self, strategy: "Strategy | str | int") -> Strategy:
        return self.strategies[self.index(strategy)]

    def add_strategy(self, strategy: Strategy) -> int:
        """Register a strategy discovered AFTER construction (the elastic
        driver's mid-run re-selection path) and return its index.

        A same-name strategy with identical annotations is a no-op (its
        existing index is returned — compiled plans stay memoized); a
        same-name strategy with DIFFERENT annotations is rejected, since
        strategies compare by name and silently rebinding one would
        poison every cache keyed on its index.  Appending re-runs
        deduction over all strategies — deterministic, so previously
        compiled plans and indices remain valid — and invalidates only
        the joint fwd+bwd graphs (their backward comm ops carry
        per-strategy annotations that cannot be extended in place)."""
        if strategy.name in self.names:
            k = self.index(strategy.name)
            if self.strategies[k].annots == strategy.annots:
                return k
            raise StrategyError(
                f"strategy {strategy.name!r} already registered with "
                f"different annotations; pick a fresh name")
        strategy.validate_against(self.graph)
        self.strategies.append(strategy)
        points = set()
        for t in self.graph.annotation_points():
            t.annots.append(strategy.annots[t.name])
            points.add(id(t))
        for t in self.graph.tensors.values():
            if id(t) not in points:
                t.annots = []
        self.report = self.graph.deduction_report()
        # train plans cache joint graphs whose backward ops were comm-
        # resolved per strategy at build time; rebuild them on demand
        self._joint_cache.clear()
        self._compile_cache = {
            key: plan for key, plan in self._compile_cache.items()
            if key[0] != "train"}
        return len(self.strategies) - 1

    # -- compile -----------------------------------------------------------
    def compile(self, strategy: "Strategy | str | int", *,
                shape_env: dict[str, int] | None = None,
                topology: Topology | None = None) -> CompiledPlan:
        """Deduction -> comm resolution -> progressive specialization.

        Memoized per (strategy, shape_env, topology): switching back to
        an already-compiled strategy returns the SAME CompiledPlan object,
        so executors keep their traced programs (JaxExecutor's cache is
        keyed by plan identity — strategy flapping doesn't retrace).
        """
        k = self.index(strategy)
        strat = self.strategies[k]
        env = dict(shape_env or {})
        topology = topology or strat.topology or _DEFAULT_TOPOLOGY
        # id() is stable here: the cached plan keeps the topology alive
        key = (k, tuple(sorted(env.items())), id(topology))
        cached = self._compile_cache.get(key)
        if cached is not None:
            return cached
        plan = self._compile_graph(self.graph, k, env, topology)
        self._compile_cache[key] = plan
        return plan

    def compile_micro(self, strategy: "Strategy | str | int",
                      num_microbatches: int, *,
                      shape_env: dict[str, int] | None = None,
                      topology: Topology | None = None) -> CompiledPlan:
        """Compile the ONE-MICROBATCH plan: every Split-role shape scaled
        by ``1/num_microbatches`` (``core.schedule.microbatch_graph``),
        re-specialized so comm plans and exec items carry microbatch
        geometry.  Memoized like :meth:`compile`; ``num_microbatches=1``
        is exactly the full plan."""
        k = self.index(strategy)
        if num_microbatches < 1:
            raise CompileError(
                f"num_microbatches must be >= 1 (got {num_microbatches})")
        if num_microbatches == 1:
            return self.compile(strategy, shape_env=shape_env,
                                topology=topology)
        strat = self.strategies[k]
        env = dict(shape_env or {})
        topology = topology or strat.topology or _DEFAULT_TOPOLOGY
        key = (k, tuple(sorted(env.items())), id(topology),
               num_microbatches)
        cached = self._compile_cache.get(key)
        if cached is not None:
            return cached
        roles = microbatch_roles(self.graph)
        micro = microbatch_graph(self.graph, num_microbatches, roles,
                                 shape_env=env)
        plan = self._compile_graph(micro, k, env, topology)
        plan.num_microbatches = num_microbatches
        plan.mb_roles = roles
        self._compile_cache[key] = plan
        return plan

    def _resolve_loss(self, loss: str | None) -> str:
        """The loss tensor's NAME (default: the single scalar sink) —
        resolved before any cache lookup so ``loss=None`` and
        ``loss="L"`` share one joint graph and one train-plan line."""
        if loss is not None:
            if loss not in self.graph.tensors:
                raise CompileError(f"unknown loss tensor {loss!r}")
            return loss
        scalars = [t for t in self.graph.sinks() if tuple(t.shape) == ()]
        if len(scalars) != 1:
            raise CompileError(
                f"graph has {len(scalars)} scalar sink(s); pass loss= "
                f"to pick the tensor to differentiate")
        return scalars[0].name

    def _joint_graph(self, loss: str) -> Graph:
        """The fwd+bwd training graph: a private copy of the deduced
        graph extended with its reverse-mode backward pass
        (``core.graph.Graph.backward``), memoized per loss tensor and
        shared by every strategy (annotations are per-strategy lists)."""
        import copy
        cached = self._joint_cache.get(loss)
        if cached is None:
            joint = copy.deepcopy(self.graph)
            try:
                joint.backward(loss)
            except GradError as e:
                raise CompileError(f"cannot build the training graph: "
                                   f"{e}") from None
            cached = self._joint_cache[loss] = joint
        return cached

    def compile_train(self, strategy: "Strategy | str | int", *,
                      loss: str | None = None,
                      num_microbatches: int = 1,
                      shape_env: dict[str, int] | None = None,
                      topology: Topology | None = None) -> CompiledPlan:
        """Compile the JOINT fwd+bwd plan for one training step.

        The forward graph is extended with real backward ops (per-op
        VJPs, gradient comm resolved by §4 like any CommOp), then
        compiled through the normal specialization path — so the
        returned plan's ExecItems carry a ``bwd`` phase, its pipelines
        are the forward pipelines, and its timetables' ``bwd`` ticks
        finally execute gradient compute + grad-reduce comm.  With
        ``num_microbatches=m > 1`` the joint graph is microbatched
        (gradients carry the Partial role: they accumulate across
        microbatches).  ``plan.grad_map`` / ``plan.loss_name`` expose
        the autodiff provenance; memoized like :meth:`compile`.
        """
        k = self.index(strategy)
        if num_microbatches < 1:
            raise CompileError(
                f"num_microbatches must be >= 1 (got {num_microbatches})")
        strat = self.strategies[k]
        env = dict(shape_env or {})
        topology = topology or strat.topology or _DEFAULT_TOPOLOGY
        loss = self._resolve_loss(loss)
        key = ("train", k, tuple(sorted(env.items())), id(topology),
               num_microbatches, loss)
        cached = self._compile_cache.get(key)
        if cached is not None:
            return cached
        joint = self._joint_graph(loss)
        if num_microbatches == 1:
            plan = self._compile_graph(joint, k, env, topology)
        else:
            roles = microbatch_roles(joint)
            micro = microbatch_graph(joint, num_microbatches, roles,
                                     shape_env=env)
            plan = self._compile_graph(micro, k, env, topology)
            plan.num_microbatches = num_microbatches
            plan.mb_roles = roles
        plan.grad_map = dict(joint.grad_map)
        plan.loss_name = joint.loss_name
        self._compile_cache[key] = plan
        return plan

    def _compile_graph(self, graph: Graph, k: int, env: dict[str, int],
                       topology: Topology) -> CompiledPlan:
        shapes: dict[str, tuple[int, ...]] = {}
        for name, t in graph.tensors.items():
            syms = free_symbols(t.shape)
            if syms - set(env):
                raise CompileError(
                    f"tensor {name!r} has unbound symbolic dims "
                    f"{sorted(syms - set(env))}; pass shape_env")
            shapes[name] = bind_shape(t.shape, env)
        spec = specialize_all(graph, k, topology, env)
        cost = _estimate_cost(graph, shapes, spec.resolved, topology)
        return CompiledPlan(graph, self.strategies[k], k, shapes, env,
                            topology, spec, cost)
