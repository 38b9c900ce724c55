"""Execution backend: run resolved communication plans across ranks.

The counterpart of ``repro/runtime/backend.py``, with the reference's
single-controller signatures on a multi-controller runtime: every rank of
the mesh (``launch.mesh.make_runtime_mesh``) calls each function with the
same arguments, moves only its own shard
(``runtime.dist_lowering.RankPlanLowering``), and gets back every
destination shard.

* :func:`execute_plan` — run a :class:`CommPlan` over per-device numpy
  shards and return the destination shards (the data moves through
  ``torch.distributed`` point-to-point messages and subgroup collectives),
* :func:`execute_sharded` — the same, adapted to the simulator's
  :class:`~repro_torch.core.simulator.ShardedTensor` (drop-in replacement
  for ``simulator.apply_plan``),
* :func:`resharding_fn` — resolve (src, dst) once and return a reusable
  migration function, caching the lowered plan per global shape,
* :func:`execute_graph` — a deduced graph's compute and comm on the ranks
  (``runtime.dist_program``),
* :func:`device_items` — the per-device :class:`ExecItem` view of a plan
  (what progressive specialization hands each device; paper §5.3).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.annotations import HSPMD
from repro_torch.core.plan import CommPlan
from repro_torch.core.simulator import ShardedTensor
from repro_torch.core.specialize import ExecItem
from repro_torch.core.topology import Topology

from .dist_lowering import RankPlanLowering, gather_shards
from .lowering import DeviceOrder


def _default_mesh():
    from repro_torch.launch.mesh import make_runtime_mesh
    return make_runtime_mesh()


class CompiledPlan:
    """A plan lowered once for a (mesh, shape, reduction) on this rank;
    reusable over fresh shard values."""

    def __init__(self, plan: CommPlan, shape: tuple[int, ...], mesh, *,
                 reduction: str = "exact"):
        if plan.src is None:
            raise ValueError("plan has no source annotation")
        self.plan = plan
        self.shape = tuple(shape)
        self.mesh = mesh
        self.order = DeviceOrder.for_plan(plan)
        self.lowering = RankPlanLowering(plan, self.shape, self.order, mesh,
                                         reduction=reduction)
        self.stats = self.lowering.stats

    def _local(self, parts: dict[int, np.ndarray]):
        """This rank's source shard on its device, and the plan's dtype
        (promoted over every source shard, as the stacked path packs)."""
        src = self.plan.src
        dtype = None
        for dev in src.devices:
            arr = np.asarray(parts[dev])
            want = tuple(src.device_shape(dev, self.shape))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"dev {dev}: shard shape {arr.shape} != {want} "
                    f"expected by the annotation")
            dtype = arr.dtype if dtype is None else \
                np.promote_types(dtype, arr.dtype)
        tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        dev = self.lowering.dev
        if dev is None or dev not in src.devices:
            return None, tdtype
        x = torch.from_numpy(np.ascontiguousarray(parts[dev]))
        return x.to(device=self.mesh.device, dtype=tdtype), tdtype

    def __call__(self, parts: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
        x, dtype = self._local(parts)
        y = self.lowering.apply(x, dtype)
        return gather_shards(self.mesh, self.order, self.plan.annots[-1],
                             self.shape, y, dtype)


def compile_plan(plan: CommPlan, shape: tuple[int, ...], mesh=None, *,
                 reduction: str = "exact") -> CompiledPlan:
    return CompiledPlan(plan, shape, mesh or _default_mesh(),
                        reduction=reduction)


def execute_plan(plan: CommPlan, parts: dict[int, np.ndarray],
                 shape: tuple[int, ...], mesh=None, *,
                 reduction: str = "exact") -> dict[int, np.ndarray]:
    """Execute ``plan`` across the ranks; ``parts`` maps each source device
    to its local shard (shaped by ``plan.src.device_box``), the same on
    every rank.  Returns every destination shard, on every rank."""
    return compile_plan(plan, shape, mesh, reduction=reduction)(parts)


def execute_sharded(st: ShardedTensor, plan: CommPlan, mesh=None, *,
                    reduction: str = "exact") -> ShardedTensor:
    """``simulator.apply_plan`` signature-compatible rank execution."""
    parts = execute_plan(plan, st.parts, st.shape, mesh,
                         reduction=reduction)
    return ShardedTensor(st.shape, plan.annots[-1], parts)


def resharding_fn(src_annot: HSPMD, dst_annot: HSPMD, mesh=None, *,
                  topology: Topology | None = None,
                  reduction: str = "exact"):
    """Resolve (src, dst) and return ``fn(parts, shape) -> parts`` that
    migrates shards across the ranks; the plan AND its lowering (with its
    subgroups) are cached per global shape."""
    from repro_torch.core.comm_resolve import resolve

    plans: dict[tuple[int, ...], CompiledPlan] = {}

    def fn(parts: dict[int, np.ndarray],
           shape: tuple[int, ...]) -> dict[int, np.ndarray]:
        shape = tuple(int(s) for s in shape)
        compiled = plans.get(shape)
        if compiled is None:
            plan = resolve(src_annot, dst_annot, shape, topology)
            compiled = plans[shape] = compile_plan(plan, shape, mesh,
                                                   reduction=reduction)
        return compiled(parts)

    fn.plans = plans
    return fn


def execute_graph(graph, strategy: int = 0, *, state=None, mesh=None,
                  shape_env=None, topology=None, fetches=None) -> dict[str, ShardedTensor]:
    """Execute a deduced graph's compute AND comm ExecItems end to end on
    the ranks (see ``runtime.dist_program``).

    ``state`` maps every leaf tensor name (placeholders + parameters) to
    its :class:`ShardedTensor`; returns the fetched tensors (default: the
    graph's sinks) as ShardedTensors under their deduced annotations, on
    every rank."""
    from .dist_program import RankLoweredGraph
    lowered = RankLoweredGraph(graph, strategy, mesh=mesh or _default_mesh(),
                               shape_env=shape_env, topology=topology,
                               fetches=fetches)
    return lowered.run(state or {})


def device_items(plan: CommPlan, device: int, name: str = "comm") -> list[ExecItem]:
    """The ExecItems ``device`` executes for this plan — identical filtering
    to :func:`repro_torch.core.specialize.specialize`'s CommOp
    substitution."""
    items = []
    for stage in plan.stages:
        for step in stage.steps:
            mine = [g for g in step.groups
                    if device in g.srcs or device in g.dsts]
            if mine or (step.kind in ("ID", "Slice")
                        and device in stage.annot_after.devices):
                items.append(ExecItem(step.kind, name, "comm",
                                      f"{len(mine)} group(s)"))
    return items
