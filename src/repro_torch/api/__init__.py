"""`repro_torch.api` — the front door to the HSPMD pipeline (the port's
copy of ``repro.api``).

One coherent compile-and-run surface over the paper's abstractions::

    from repro_torch import api

    g = api.Graph()                       # single-device view (§5.1)
    x = g.placeholder("X", (8, 16))
    w = g.parameter("W", (16, 4))
    y = g.dot(x, g.comm(w, name="W'"), name="Y")

    tp = api.Strategy("tp", {...})        # named annotation bundles (§3)
    dp = api.Strategy("dp", {...})
    prog = api.Program(g, [tp, dp])       # deduction per strategy (§6.1)

    plan = prog.compile("tp")             # §4 comm resolution + §5.3-5.4
    plan.exec_items(device)               #   per-device executable graph
    plan.cost.summary()                   #   analytic cost / roofline

    sess = api.Session(prog, "tp", executor=api.TorchExecutor())
    sess.load({"W": w_value})
    out = sess.run({"X": x_value})        # stacked rows on one GPU (§5.3)
    out = sess.run({"X": x_value},        # microbatched 1F1B pipeline
                   num_microbatches=4,    #   over plan.pipelines (§5.4)
                   schedule="1f1b")
    report = sess.switch("dp")            # fused-BSR, restart-free (§6.2)

Executors are pluggable (:class:`Executor`): ``SimulatorExecutor`` runs
the virtual-device numpy spec, ``TorchExecutor`` runs every virtual device
as one row of stacked buffers on one torch device (``runtime.program``),
``AsyncExecutor`` runs the same rows as one program per pipeline stage
over the explicit timetable, each stage on its own CUDA stream
(``runtime.async_program``), ``DistExecutor`` runs each device on its
own ``torch.distributed`` rank (``runtime.dist_program``), and
``DistAsyncExecutor`` runs the per-stage programs there, one pipeline
stage per rank (``runtime.dist_async_program``) — bit-exact against each
other on exactly representable data.
"""

from repro_torch.core.annotations import (DG, DS, DUP, PARTIAL, HSPMD, replicated,
                                          spmd)
from repro_torch.core.comm_resolve import resolve
from repro_torch.core.graph import (DeductionError, DeductionReport, GradError,
                                    Graph, VJP_RULES, cotangent_annot)
from repro_torch.core.op_semantics import MicrobatchError
from repro_torch.core.plan import CommPlan
from repro_torch.core.schedule import (PipelineSchedule, PricedSchedule,
                                       ScheduleError, ScheduleStats, Tick,
                                       build_schedule, price_schedule)
from repro_torch.core.simulator import ShardedTensor, gather, scatter
from repro_torch.core.specialize import (ExecItem, ExecutableGraph, Pipeline,
                                         SpecializationResult)
from repro_torch.core.switching import (SwitchOutcome, SwitchReport,
                                        plan_tensor_switch)
from repro_torch.core.topology import (NvlinkIbTopology, Topology,
                                       UniformTopology)

from repro_torch.runtime.async_program import AsyncExecutor

from .executors import (DistAsyncExecutor, DistExecutor, Executor,
                        SimulatorExecutor, TorchExecutor, get_executor)
from .program import CompiledPlan, CompileError, CostEstimate, Program
from .session import RunResult, Session, TrainResult
from .strategy import (Strategy, StrategyError, data_parallel_strategy,
                       weights_graph)

# deprecation-friendly alias: the scenarios' old hand-rolled
# "build tensors + plan_fused_bsr + est_time" dance, as one call
estimate_switch = plan_tensor_switch

__all__ = [
    "DG", "DS", "DUP", "PARTIAL", "HSPMD", "replicated", "spmd",
    "AsyncExecutor", "DistAsyncExecutor", "DistExecutor",
    "CommPlan", "CompileError", "CompiledPlan", "CostEstimate",
    "DeductionError", "DeductionReport", "ExecItem", "ExecutableGraph",
    "Executor", "GradError", "Graph", "MicrobatchError",
    "NvlinkIbTopology", "Pipeline", "PipelineSchedule", "PricedSchedule",
    "Program", "RunResult", "ScheduleError", "ScheduleStats", "Session",
    "ShardedTensor", "SimulatorExecutor", "SpecializationResult",
    "Strategy", "StrategyError", "SwitchOutcome", "SwitchReport", "Tick",
    "Topology", "TorchExecutor", "TrainResult", "UniformTopology",
    "VJP_RULES",
    "build_schedule", "cotangent_annot", "data_parallel_strategy",
    "estimate_switch", "gather", "get_executor", "plan_tensor_switch",
    "price_schedule", "resolve", "scatter", "weights_graph",
]
