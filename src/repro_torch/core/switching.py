"""Dynamic graph switching (paper §6, Fig 12).

A tensor bound to multiple annotations yields one annotated graph per
parallel strategy (§6.1).  Switching strategies = re-sharding every weight
from its source annotation to its destination annotation, modeled as one
**fused BSR** task over all tensors (§6.2): a single global BSR table,
heuristics + per-pair message fusion, load-balanced across the whole
transition.

``switch`` also executes the plan, on the virtual-device simulator
(``backend="sim"``), on the torch comm lowering (``backend="torch"``:
every virtual device one row of a stacked buffer on one torch device) or
across ``torch.distributed`` ranks (``backend="dist"``), so the weight
migration is verified numerically, and reports the statistics
the paper uses in Fig 18 / Table 2 (per-rank volume over fast/slow links,
message counts, estimated transition time).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .annotations import HSPMD
from .bsr import BsrPlan, plan_bsr_naive, plan_fused_bsr, plan_unfused_bsr
from .graph import Graph
from .plan import CommPlan
from .simulator import ShardedTensor, apply_plan
from .topology import Topology, UniformTopology


@dataclass
class SwitchReport:
    plan: BsrPlan
    planning_seconds: float
    est_transfer_seconds: float
    total_bytes: int
    message_count: int
    per_sender: dict[int, tuple[int, int]] = field(default_factory=dict)
    # stamped by Session.switch for consumers that track live transitions
    # (the elastic trace driver): measured end-to-end wall seconds of the
    # whole switch (plan + execute + recompile) and the strategy names
    wall_seconds: float = 0.0
    src_name: str = ""
    dst_name: str = ""
    # host-clock seconds of the torch backend's parts, summed over every
    # tensor it migrated under this report (weights, then AdamW m and v):
    # "lower", "pack", "move", "unpack" (``runtime.lowering.execute_plan``)
    execute_seconds: dict[str, float] = field(default_factory=dict)

    def summary(self) -> str:
        arrow = (f"{self.src_name} -> {self.dst_name}: "
                 if self.src_name or self.dst_name else "")
        return (f"{arrow}{self.message_count} msgs, "
                f"{self.total_bytes / 1e6:.1f} MB, "
                f"plan {self.planning_seconds * 1e3:.1f} ms, "
                f"est transfer {self.est_transfer_seconds * 1e3:.1f} ms")


def plan_tensor_switch(tensors, topology: Topology | None = None,
                       mode: str = "fused") -> SwitchReport:
    """Plan one global BSR migration over ``(name, src_annot, dst_annot,
    shape, itemsize)`` tuples — the shared core of graph switching and the
    scenario cost models (elastic / mixed-length)."""
    topology = topology or UniformTopology()
    t0 = time.perf_counter()
    if mode == "fused":
        plan = plan_fused_bsr(tensors, topology)
    elif mode == "unfused":
        plan = plan_unfused_bsr(tensors, topology)
    elif mode == "naive":
        assignments = []
        for name, s, d, shape, isz in tensors:
            assignments.extend(plan_bsr_naive(s, d, shape, name, isz).assignments)
        plan = BsrPlan(assignments, fused=False)
    else:
        raise ValueError(mode)
    dt = time.perf_counter() - t0
    return SwitchReport(
        plan=plan,
        planning_seconds=dt,
        est_transfer_seconds=plan.est_time(topology),
        total_bytes=plan.total_bytes(),
        message_count=plan.message_count(),
        per_sender=plan.per_sender_bytes(topology),
    )


def plan_switch(graph: Graph, src_strategy: int, dst_strategy: int,
                shape_env: dict[str, int] | None = None,
                topology: Topology | None = None,
                mode: str = "fused", itemsize=2) -> SwitchReport:
    """Plan the weight migration between two annotated strategies.

    ``itemsize`` prices the byte/time statistics: an int (default 2 =
    bf16, the paper's training dtype) or a per-tensor ``name -> int``
    callable (``switch`` below passes the live weights' itemsizes).
    """
    from .symbolic import bind_shape
    isz = itemsize if callable(itemsize) else (lambda name: itemsize)
    tensors = []
    for p in graph.parameters():
        shape = bind_shape(p.shape, shape_env or {})
        tensors.append((p.name, p.annots[src_strategy],
                        p.annots[dst_strategy], shape, isz(p.name)))
    return plan_tensor_switch(tensors, topology, mode)


def execute_switch(weights: dict[str, ShardedTensor],
                   graph: Graph, src_strategy: int, dst_strategy: int,
                   shape_env: dict[str, int] | None = None,
                   topology: Topology | None = None, *,
                   backend: str = "sim", device=None, mesh=None,
                   report: SwitchReport | None = None
                   ) -> dict[str, ShardedTensor]:
    """Migrate weight shards to the destination strategy.

    Per-tensor plans share the fused global planning state; execution is
    per tensor either on the virtual-device simulator (``backend="sim"``,
    numerically exact) or on the torch comm lowering (``backend="torch"``:
    each tensor's ``switch:BSR`` plan runs as row moves on ``device``,
    ``None`` meaning ``cuda``; BSR moves copies only, so every shard is
    bit for bit the simulator's) or across ranks (``backend="dist"``: each
    tensor's plan through ``runtime.backend.execute_plan`` on ``mesh``, a
    ``launch.mesh.RankMesh``, every rank calling with the same weights and
    getting every migrated shard back; the counterpart of the reference's
    ``backend="jax"``).  The torch backend adds its parts' times to
    ``report.execute_seconds``.  The reference's ``backend="jax"`` raises
    here."""
    from .symbolic import bind_shape
    if backend == "jax":
        raise NotImplementedError(
            "switch backend 'jax' is the JAX package's; the port migrates "
            "across ranks with backend='dist', on the torch comm lowering "
            "with backend='torch', or on the simulator with backend='sim'")
    if backend not in ("sim", "torch", "dist"):
        raise ValueError(f"unknown switch backend {backend!r}")
    if report is None:
        report = plan_switch(graph, src_strategy, dst_strategy, shape_env,
                             topology, mode="fused")
    by_tensor: dict[str, list] = {}
    for a in report.plan.assignments:
        by_tensor.setdefault(a.tensor, []).append(a)

    out: dict[str, ShardedTensor] = {}
    for p in graph.parameters():
        src = p.annots[src_strategy]
        dst = p.annots[dst_strategy]
        shape = bind_shape(p.shape, shape_env or {})
        sub = BsrPlan(by_tensor.get(p.name, []), fused=True)
        cp = CommPlan(src=src, dst=dst, kind="switch:BSR")
        cp.add(sub.to_step(), dst)
        if backend == "torch":
            from repro_torch.runtime.lowering import execute_plan
            parts = execute_plan(cp, weights[p.name].parts, shape, device,
                                 times=report.execute_seconds)
            out[p.name] = ShardedTensor(tuple(shape), dst, parts)
        elif backend == "dist":
            from repro_torch.runtime.backend import execute_plan
            parts = execute_plan(cp, weights[p.name].parts, shape, mesh)
            out[p.name] = ShardedTensor(tuple(shape), dst, parts)
        else:
            out[p.name] = apply_plan(weights[p.name], cp)
    return out


@dataclass
class SwitchOutcome:
    """Stable result of a planned-and-executed strategy switch."""

    weights: dict[str, ShardedTensor]
    report: SwitchReport
    src_strategy: int
    dst_strategy: int


def switch(weights: dict[str, ShardedTensor],
           graph: Graph, src_strategy: int, dst_strategy: int,
           shape_env: dict[str, int] | None = None,
           topology: Topology | None = None, *,
           backend: str = "sim", device=None, mesh=None) -> SwitchOutcome:
    """Plan + execute the fused-BSR strategy switch, returning both the
    migrated weights and the planning/transfer report (paper §6.2) —
    what ``repro_torch.api.Session.switch`` composes.  Report statistics
    are priced at each live weight's actual itemsize; ``backend``,
    ``device`` and ``mesh`` are :func:`execute_switch`'s."""

    def isz(name: str) -> int:
        st = weights.get(name)
        if st is None:
            return 2
        return np.asarray(next(iter(st.parts.values()))).dtype.itemsize

    report = plan_switch(graph, src_strategy, dst_strategy, shape_env,
                         topology, mode="fused", itemsize=isz)
    new = execute_switch(weights, graph, src_strategy, dst_strategy,
                         shape_env, topology, backend=backend,
                         device=device, mesh=mesh, report=report)
    return SwitchOutcome(new, report, src_strategy, dst_strategy)
