"""Specialization-class lowering IR (between deduction and execution).

Progressive specialization (``core.specialize``) instantiates one
executable graph *per device*.  Executing that literally — one dispatch
per (op, device) — is what made the lowered jax program a forest of
``n_mesh``-way ``lax.switch``es and the simulator a per-device python
loop, even though in the common SPMD case every participating device
runs the *identical* local computation (same local input shapes, same
local output shape, same kernel implementation, same attrs).

This module computes the quotient: for each compute op under a strategy,
the **equivalence classes of devices that share the local computation**,
and groups maximal runs of compute ops between comm ops into
:class:`Segment`\\ s with a joint class partition (devices equivalent for
*every* op of the run).  Both executors lower onto it:

* ``runtime.program.LoweredGraph`` emits ONE branch per class per
  segment — the homogeneous case (one class, every device) becomes
  straight-line unpadded code with zero switches; the hetero / pipeline
  case gets a small switch over classes, not devices,
* ``api.executors.SimulatorExecutor`` applies one vectorized numpy
  kernel over a class's stacked shards instead of dispatching per
  device.

The per-device :class:`~repro_torch.core.specialize.ExecItem` lists remain the
ground truth: :func:`check_against_exec_items` asserts that devices
placed in one class really do carry identical compute item sequences
over the segment (GSPMD's shared-program-for-symmetric-shards insight,
with the asymmetric classes kept first-class as HAP motivates).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

from .graph import Graph, Op
from .symbolic import bind_shape

#: impl tag for ops executed through the shared local semantics
#: (``core.op_semantics.local_apply``) rather than a dedicated kernel
SHARED_IMPL = ""

ImplOf = Callable[[Op, int], str]


@dataclass(frozen=True)
class OpSpec:
    """What one device of a class executes for one op: the static
    device-local geometry plus the kernel implementation tag."""

    in_shapes: tuple[tuple[int, ...], ...]
    out_shape: tuple[int, ...]
    impl: str = SHARED_IMPL


@dataclass(frozen=True)
class SegmentClass:
    """One specialization class: the devices sharing an identical local
    program over a segment (``specs[i] is None`` where the class does
    not run ``ops[i]`` — partial participation is just another class)."""

    devices: tuple[int, ...]
    specs: tuple["OpSpec | None", ...]

    @property
    def n_devices(self) -> int:
        return len(self.devices)


@dataclass
class Segment:
    """A maximal run of compute ops between comm ops, with the joint
    class partition of the participating devices."""

    ops: list[Op]
    classes: list[SegmentClass]
    idle_devices: tuple[int, ...]

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    def class_of(self, dev: int) -> int | None:
        """Index of ``dev``'s class, or ``None`` if it idles through the
        whole segment."""
        for i, cls in enumerate(self.classes):
            if dev in cls.devices:
                return i
        return None

    def is_homogeneous(self) -> bool:
        """One class, no idle devices: every device runs the identical
        local program — the straight-line (zero-switch) case."""
        return len(self.classes) == 1 and not self.idle_devices

    def describe(self) -> str:
        kinds = "+".join(op.kind for op in self.ops)
        sizes = "/".join(str(c.n_devices) for c in self.classes)
        idle = f" idle={len(self.idle_devices)}" if self.idle_devices \
            else ""
        return f"[{kinds}] classes={self.n_classes} ({sizes}){idle}"


@dataclass
class CommSlot:
    """A CommOp in execution order — a segment boundary."""

    op: Op


@dataclass
class LoweredIR:
    """The segment sequence of one (graph, strategy): alternating
    compute :class:`Segment`\\ s and :class:`CommSlot`\\ s, in op order."""

    strategy: int
    devices: tuple[int, ...]
    entries: list["Segment | CommSlot"]

    @property
    def segments(self) -> list[Segment]:
        return [e for e in self.entries if isinstance(e, Segment)]

    @property
    def comm_slots(self) -> list[CommSlot]:
        return [e for e in self.entries if isinstance(e, CommSlot)]

    def class_counts(self) -> list[int]:
        return [s.n_classes for s in self.segments]

    def total_classes(self) -> int:
        return sum(self.class_counts())

    def describe(self) -> str:
        lines = [f"strategy {self.strategy}: {len(self.segments)} "
                 f"segment(s), {len(self.comm_slots)} comm op(s), "
                 f"{len(self.devices)} device(s)"]
        for e in self.entries:
            lines.append("  " + (e.describe() if isinstance(e, Segment)
                                 else f"comm {e.op.outputs[0].name}"))
        return "\n".join(lines)


def op_participants(op: Op, strategy: int) -> tuple[int, ...]:
    """The devices that execute ``op`` — exactly progressive
    specialization's rule: compute ops run where their OUTPUT lives
    (``core.specialize.specialize``)."""
    if not op.outputs:
        return ()
    return op.outputs[0].annots[strategy].devices


def op_spec(op: Op, dev: int, strategy: int,
            shapes: dict[str, tuple[int, ...]],
            impl_of: ImplOf | None = None) -> OpSpec:
    """The static local-execution record of ``op`` on ``dev``."""
    out_t = op.outputs[0]
    in_shapes = tuple(
        tuple(t.annots[strategy].device_shape(dev, shapes[t.name]))
        for t in op.inputs)
    out_shape = tuple(
        out_t.annots[strategy].device_shape(dev, shapes[out_t.name]))
    impl = impl_of(op, dev) if impl_of is not None else SHARED_IMPL
    return OpSpec(in_shapes, out_shape, impl)


def _partition_segment(ops: list[Op], devices: Sequence[int],
                       strategy: int,
                       shapes: dict[str, tuple[int, ...]],
                       impl_of: ImplOf | None) -> Segment:
    """Joint class partition of one compute run: devices are equivalent
    iff their per-op specs agree for EVERY op of the run.  Classes are
    ordered by first device appearance in ``devices`` order, so the
    partition *structure* (class sizes, specs) is invariant under device
    renumbering."""
    sigs: dict[int, tuple] = {}
    for dev in devices:
        sig = []
        for op in ops:
            if dev in op_participants(op, strategy):
                sig.append(op_spec(op, dev, strategy, shapes, impl_of))
            else:
                sig.append(None)
        sigs[dev] = tuple(sig)
    classes: list[SegmentClass] = []
    by_sig: dict[tuple, list[int]] = {}
    order: list[tuple] = []
    for dev in devices:
        sig = sigs[dev]
        if sig not in by_sig:
            by_sig[sig] = []
            order.append(sig)
        by_sig[sig].append(dev)
    idle: tuple[int, ...] = ()
    for sig in order:
        members = tuple(by_sig[sig])
        if all(s is None for s in sig):
            idle = members
        else:
            classes.append(SegmentClass(members, sig))
    return Segment(list(ops), classes, idle)


def partition_graph(graph: Graph, strategy: int = 0, *,
                    shapes: dict[str, tuple[int, ...]] | None = None,
                    shape_env: dict[str, int] | None = None,
                    impl_of: ImplOf | None = None,
                    devices: Iterable[int] | None = None,
                    ops: Iterable[Op] | None = None) -> LoweredIR:
    """Compute the specialization-class IR of a deduced graph under one
    strategy.

    ``impl_of(op, dev)`` optionally refines the partition by kernel
    implementation (the attention ref↔Pallas seam): devices whose local
    shard shapes agree but whose kernel dispatch differs land in
    different classes.  ``shapes`` (or ``shape_env`` for symbolic
    graphs) binds tensor shapes; ``devices`` defaults to the union of
    all annotated devices.

    ``ops`` restricts the walk to a subset of ``graph.ops`` (kept in
    graph order by the caller) — the per-stage MPMD lowering partitions
    each (virtual stage, phase) bucket separately, since a whole-graph
    segment may span a stage/phase boundary that has no comm op on it
    (e.g. the last stage's loss: fwd flows into bwd with no comm
    between).
    """
    if shapes is None:
        env = shape_env or {}
        shapes = {name: bind_shape(t.shape, env)
                  for name, t in graph.tensors.items()}
    if devices is None:
        devs: set[int] = set()
        for t in graph.tensors.values():
            if t.annots:
                devs |= set(t.annots[strategy].devices)
        devices = tuple(sorted(devs))
    else:
        devices = tuple(devices)

    entries: list[Segment | CommSlot] = []
    run: list[Op] = []

    def flush():
        if run:
            entries.append(_partition_segment(
                run, devices, strategy, shapes, impl_of))
            run.clear()

    for op in (graph.ops if ops is None else ops):
        if op.kind in ("placeholder", "parameter"):
            continue
        if op.kind == "comm":
            flush()
            entries.append(CommSlot(op))
        else:
            run.append(op)
    flush()
    return LoweredIR(strategy, devices, entries)


def check_against_exec_items(ir: LoweredIR, specialization) -> None:
    """Assert the class partition against progressive specialization's
    per-device ExecItems (the ground truth): two devices share a class
    iff their compute-item sequences over the segment's ops are
    identical.  Raises ``AssertionError`` on any divergence."""
    for seg in ir.segments:
        names = [op.outputs[0].name for op in seg.ops]
        item_sig: dict[int, tuple] = {}
        for dev in ir.devices:
            if dev not in specialization.exec_graphs:
                item_sig[dev] = ()
                continue
            mine = {i.name: i.kind
                    for i in specialization.items(dev)
                    if i.role == "compute"}
            item_sig[dev] = tuple(
                (n, mine[n]) for n in names if n in mine)
        for cls in seg.classes:
            sig0 = item_sig[cls.devices[0]]
            for dev in cls.devices[1:]:
                if item_sig[dev] != sig0:
                    raise AssertionError(
                        f"devices {cls.devices[0]} and {dev} share a "
                        f"class but their ExecItems differ over "
                        f"segment {seg.describe()}")
        for dev in seg.idle_devices:
            if item_sig[dev]:
                raise AssertionError(
                    f"device {dev} is idle in {seg.describe()} but has "
                    f"compute ExecItems {item_sig[dev]}")
