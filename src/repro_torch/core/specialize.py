"""Progressive graph specialization (paper §5.3-5.4, Fig 9).

From a deduced (annotated) graph, instantiate a *device-specific executable
graph* per device:

1. **Non-local operator removal** — ops whose input and output tensors never
   place data on the device are pruned.
2. **CommOp substitution** — every CommOp is resolved (§4) into concrete
   communication steps; a device keeps only the steps it participates in.
   Top-tier communication replaces the CommOp uniformly across the DG
   union; bottom-tier communication is substituted per sharding subgroup
   (Fig 9's CommOp id=2 becoming RS on GPU0 but BSR on GPU6).
3. **Pipeline construction** — devices start as singleton pipelines;
   scanning the scheduled CommOps, collective participants merge into one
   pipeline and P2P receivers append as successor stages.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .annotations import HSPMD
from .comm_resolve import resolve
from .graph import Graph, Op
from .plan import CommPlan, CommStep
from .topology import Topology, UniformTopology


@dataclass
class ResolvedComm:
    op: Op
    plan: CommPlan


@dataclass
class ExecItem:
    """One node of a device's executable graph."""

    kind: str                   # op kind, or a comm step kind (AR/RS/.../BSR)
    name: str
    role: str = "compute"       # compute | comm
    detail: str = ""
    phase: str = "fwd"          # fwd | bwd (autodiff backward extension)


@dataclass
class ExecutableGraph:
    device: int
    items: list[ExecItem] = field(default_factory=list)

    def kinds(self) -> list[str]:
        return [i.kind for i in self.items]

    def phase_items(self, phase: str) -> list[ExecItem]:
        """This device's items for one schedule phase — what a fwd/bwd
        tick of the pipeline timetable executes."""
        return [i for i in self.items if i.phase == phase]


def resolve_comm_ops(graph: Graph, strategy: int = 0,
                     topology: Topology | None = None,
                     shape_env: dict[str, int] | None = None
                     ) -> list[ResolvedComm]:
    """Apply hierarchical communication resolution to every CommOp."""
    from .symbolic import bind_shape
    topology = topology or UniformTopology()
    out = []
    for op in graph.comm_ops:
        src = op.inputs[0].annots[strategy]
        dst = op.outputs[0].annots[strategy]
        shape = op.inputs[0].shape
        if not all(isinstance(s, int) for s in shape):
            if shape_env is None:
                raise ValueError(
                    f"CommOp on {op.inputs[0].name} has symbolic shape; "
                    f"bind symbols before specialization")
            shape = bind_shape(shape, shape_env)
        plan = resolve(src, dst, tuple(int(s) for s in shape), topology)
        out.append(ResolvedComm(op, plan))
    return out


def _device_in_annots(device: int, *annots: HSPMD) -> bool:
    return any(device in a.devices for a in annots)


def specialize(graph: Graph, device: int, strategy: int = 0,
               topology: Topology | None = None,
               shape_env: dict[str, int] | None = None,
               resolved_comms: list[ResolvedComm] | None = None
               ) -> ExecutableGraph:
    """Instantiate the executable graph for one device (paper Fig 9).

    ``resolved_comms`` shares one communication resolution across the
    per-device calls (``specialize_all`` passes it).
    """
    if resolved_comms is None:
        resolved_comms = resolve_comm_ops(graph, strategy, topology,
                                          shape_env)
    resolved = {id(rc.op): rc for rc in resolved_comms}
    eg = ExecutableGraph(device)
    for op in graph.ops:
        annots = [t.annots[strategy] for t in op.inputs + op.outputs]
        if not any(device in a.devices for a in annots):
            continue  # non-local operator removal
        phase = "bwd" if op.attrs.get("phase") == "bwd" else "fwd"
        if op.kind == "comm":
            rc = resolved[id(op)]
            for stage in rc.plan.stages:
                for step in stage.steps:
                    mine = [g for g in step.groups
                            if device in g.srcs or device in g.dsts]
                    if mine or (step.kind in ("ID", "Slice")
                                and device in stage.annot_after.devices):
                        eg.items.append(ExecItem(
                            step.kind, f"comm{op.attrs['id']}", "comm",
                            f"{len(mine)} group(s)", phase))
        else:
            # compute ops run only where their OUTPUT lives
            out_annots = [t.annots[strategy] for t in op.outputs]
            if op.outputs and not _device_in_annots(device, *out_annots):
                continue
            eg.items.append(ExecItem(op.kind, op.outputs[0].name
                                     if op.outputs else op.kind,
                                     phase=phase))
    return eg


@dataclass
class SpecializationResult:
    """Stable result of progressive specialization across ALL devices —
    what ``repro.api.Program.compile`` composes into a CompiledPlan."""

    strategy: int
    devices: tuple[int, ...]
    exec_graphs: dict[int, ExecutableGraph]
    resolved: list[ResolvedComm]
    pipelines: list["Pipeline"]

    def items(self, device: int) -> list[ExecItem]:
        return self.exec_graphs[device].items


def specialize_all(graph: Graph, strategy: int = 0,
                   topology: Topology | None = None,
                   shape_env: dict[str, int] | None = None
                   ) -> SpecializationResult:
    """Specialize every participating device, sharing one communication
    resolution, and construct the pipelines (paper §5.3-5.4)."""
    resolved = resolve_comm_ops(graph, strategy, topology, shape_env)
    devices: set[int] = set()
    for t in graph.tensors.values():
        if t.annots:
            devices |= set(t.annots[strategy].devices)
    exec_graphs = {
        dev: specialize(graph, dev, strategy, topology, shape_env,
                        resolved_comms=resolved)
        for dev in sorted(devices)}
    pipelines = construct_pipelines(graph, strategy, topology=topology,
                                    shape_env=shape_env,
                                    resolved_comms=resolved)
    return SpecializationResult(strategy, tuple(sorted(devices)),
                                exec_graphs, resolved, pipelines)


# ---------------------------------------------------------------------------
# pipeline construction (paper §5.4)
# ---------------------------------------------------------------------------

@dataclass
class Pipeline:
    """An ordered list of stages; each stage is a set of devices."""

    stages: list[set[int]] = field(default_factory=list)

    def devices(self) -> set[int]:
        return set().union(*self.stages) if self.stages else set()

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def stage_of(self, dev: int) -> int | None:
        """This device's stage index (its position in the timetable the
        schedule engine builds), or None if the device is not staged."""
        for i, devs in enumerate(self.stages):
            if dev in devs:
                return i
        return None


def construct_pipelines(graph: Graph, strategy: int = 0,
                        scheduled_only: bool = True,
                        topology: Topology | None = None,
                        shape_env: dict[str, int] | None = None,
                        resolved_comms: list[ResolvedComm] | None = None
                        ) -> list[Pipeline]:
    """Step-by-step pipeline construction (Fig 9, bottom right).

    Every device starts as its own single-stage pipeline.  For each
    scheduled CommOp (one-shot CommOps — e.g. a parameter reshard that
    executes once — are excluded, mirroring the paper's exclusion of
    CommOp id=1): devices coupled by *collective* steps merge into the
    same stage; *P2P* steps append the receiver devices as a successor
    stage of the sender's pipeline.
    """
    # union-find over devices for stage merging
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    successors: list[tuple[int, int]] = []  # (src_dev, dst_dev) stage edges

    if resolved_comms is None:
        resolved_comms = resolve_comm_ops(graph, strategy, topology,
                                          shape_env)
    for rc in resolved_comms:
        op = rc.op
        # backward CommOps (activation-grad sends, parameter grad
        # reduces) mirror the forward dataflow in REVERSE — the pipeline
        # structure is defined by the forward half alone
        if op.attrs.get("phase") == "bwd":
            continue
        if scheduled_only:
            # one-shot CommOps feed parameters; scheduled ones feed
            # activations/gradients (have a compute producer upstream)
            src_t = op.inputs[0]
            if src_t.producer is not None and src_t.producer.kind == "parameter":
                continue
        for stage in rc.plan.stages:
            for step in stage.steps:
                for g in step.groups:
                    devs = set(g.srcs) | set(g.dsts)
                    if step.kind in ("AR", "RS", "AG", "SplitAR", "SplitRS",
                                     "SplitAG"):
                        devs_l = sorted(devs)
                        for d in devs_l[1:]:
                            union(devs_l[0], d)
                    else:  # SR / BSR are P2P: receiver becomes a next stage
                        for s in g.srcs:
                            for d in g.dsts:
                                if s != d:
                                    successors.append((s, d))

    all_devices = set()
    for t in graph.tensors.values():
        if t.annots:
            all_devices |= set(t.annots[strategy].devices)

    # build stages from union-find roots
    stages: dict[int, set[int]] = {}
    for d in sorted(all_devices):
        stages.setdefault(find(d), set()).add(d)

    # link stages by successor edges
    nexts: dict[int, set[int]] = {}
    has_pred: set[int] = set()
    for s, d in successors:
        rs, rd = find(s), find(d)
        if rs != rd:
            nexts.setdefault(rs, set()).add(rd)
            has_pred.add(rd)

    pipelines = []
    visited_any: set[int] = set()

    def walk(root: int) -> Pipeline:
        pipe = Pipeline()
        frontier = [root]
        seen: set[int] = set()
        while frontier:
            stage_devs = set()
            nxt = []
            for r in frontier:
                if r in seen:
                    continue
                seen.add(r)
                stage_devs |= stages[r]
                nxt.extend(sorted(nexts.get(r, ())))
            if stage_devs:
                pipe.stages.append(stage_devs)
            frontier = nxt
        visited_any.update(seen)
        return pipe

    for root in sorted(stages):
        if root in has_pred:
            continue
        pipelines.append(walk(root))
    # Interleaved dataflow (virtual stages, paper §5.4 + Megatron's
    # virtual-pipeline layout) wraps the last stage's P2P back to the
    # first, so every stage group has a predecessor and no pred-less
    # root exists.  Start such cyclic chains from the earliest P2P
    # sender in CommOp order — the stage the first microbatch enters.
    for s, _ in successors:
        rs = find(s)
        if rs in stages and rs not in visited_any:
            pipelines.append(walk(rs))
    return pipelines
