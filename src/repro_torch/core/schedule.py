"""Pipeline schedule engine: 1F1B / GPipe / interleaved timetables over
`CompiledPlan.pipelines`.

Progressive specialization (paper §5.3-5.4) builds the *spatial* half of
a strategy — per-device executable graphs linked into pipelines.  This
module supplies the *temporal* half: given the pipeline's stage count and
a microbatch count it emits an explicit per-stage timetable of
``(slot, stage, microbatch, phase)`` :class:`Tick`\\ s for the three
canonical synchronous schedules,

* **GPipe** — all ``m`` forwards flow through, then all ``m`` backwards
  drain back; every stage holds up to ``m`` in-flight microbatches,
* **1F1B** — each stage warms up with ``min(S-1-stage, m)`` forwards and
  then strictly alternates one-forward-one-backward, bounding in-flight
  microbatches by the stage depth instead of ``m`` (JaxPP / Megatron's
  memory-bounded schedule),
* **interleaved 1F1B** — Megatron's virtual-stage schedule: each of the
  ``S`` physical stages (devices) holds ``v`` model chunks, so the model
  traverses the device ring ``v`` times through ``S*v`` *virtual*
  stages.  ``Tick.stage`` is then the virtual stage index; the owning
  device is ``stage % S`` (chunk ``stage // S``).  The per-device unit
  order is Megatron's (warmup of ``2*(S-1-s) + (v-1)*S`` forwards, then
  strict 1F1B alternation over virtual microbatch units); slots come
  from a uniform-tick list scheduling of that order, so the emitted
  timetable is dependency-valid by construction and ``v=1`` degenerates
  to exactly the 1F1B table.

Uniform 1F1B/GPipe share the fill/drain shape the analytic cost model
prices (``costmodel.fill_drain_count``): with uniform fwd/bwd tick costs
the timetable spans exactly ``2 * (m + S - 1)`` slots.  ``validate``
checks the dependency structure (fwd follows the previous virtual
stage, bwd follows the next virtual stage, one tick per *device* per
slot); :class:`ScheduleStats` surfaces ticks / bubbles / p2p message
counts on ``CompiledPlan`` and ``RunResult``.

Ticks need not be uniform: ``price_schedule`` re-times any valid
timetable under per-``(stage, phase)`` durations (seconds, priced from
``costmodel.pipeline_tick_durations`` for analytic strategies) by the
same list scheduling — each tick starts when its device is free and its
dependencies have finished — yielding a :class:`PricedSchedule` with
real start/finish times, the priced **makespan** and the
**bubble fraction** (idle device-time share).  With all durations equal
to 1 the priced makespan reproduces the slot count exactly, which is
what pins the closed-form ``2*(m+S-1)`` uniform case to the priced
path.

The second half of the module maps a *graph* onto the timetable:
``microbatch_roles`` propagates how each tensor relates to the batch
split (Split / Duplicate / Partial — ``op_semantics.microbatch_role``),
``microbatch_graph`` scales a deduced graph's shapes down to one
microbatch, ``assign_stages`` buckets ops into (virtual) pipeline
stages, ``infer_virtual_stages`` counts how many chunks per device a
graph's dataflow actually makes, and ``combine_outputs`` reduces
per-microbatch fetches back to full-batch values (sum Partial,
concatenate Split, take-one Duplicate).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np

from . import op_semantics
from .annotations import DUP, PARTIAL
from .graph import Graph
from .op_semantics import MB_DUP, MB_PARTIAL, MicrobatchError
from .specialize import Pipeline

SCHEDULES = ("1f1b", "gpipe", "interleaved")


class ScheduleError(ValueError):
    """Invalid schedule request (unknown kind, bad microbatch count)."""


@dataclass(frozen=True)
class Tick:
    """One unit of pipeline work: virtual ``stage`` runs ``phase`` for
    ``microbatch`` during time ``slot``.  Slots are the uniform-duration
    ordering; real (non-uniform) durations are applied by
    :func:`price_schedule`."""

    slot: int
    stage: int            # VIRTUAL stage index (== physical when v == 1)
    microbatch: int
    phase: str            # "fwd" | "bwd"


@dataclass(frozen=True)
class ScheduleStats:
    """Static accounting of one timetable.

    ``makespan`` / ``bubble_fraction`` are *priced*: computed by
    re-timing the timetable under per-(stage, phase) tick durations
    (:func:`price_schedule`; uniform 1.0 by default, in which case
    ``makespan == n_slots``)."""

    n_ticks: int          # compute ticks actually scheduled (2 * m * S * v)
    n_slots: int          # timeline length in slots
    bubbles: int          # idle (device, slot) cells across the timetable
    p2p_messages: int     # stage-boundary sends (fwd activations + bwd grads)
    makespan: float = 0.0        # priced end-to-end time
    bubble_fraction: float = 0.0  # idle share of device-time, priced

    def summary(self) -> str:
        return (f"{self.n_ticks} ticks over {self.n_slots} slots, "
                f"{self.bubbles} bubbles, {self.p2p_messages} p2p msgs, "
                f"makespan {self.makespan:g} "
                f"({self.bubble_fraction:.0%} bubble)")


@dataclass
class PipelineSchedule:
    """An explicit timetable: ``ticks`` ordered by (slot, stage).

    ``n_stages`` is the *physical* stage (device) count;
    ``virtual_per_stage`` is Megatron's ``v`` — model chunks per device —
    so ticks index ``n_virtual = n_stages * virtual_per_stage`` virtual
    stages and ``device_of`` maps them back to devices."""

    kind: str
    n_stages: int
    num_microbatches: int
    ticks: list[Tick] = field(default_factory=list)
    virtual_per_stage: int = 1

    @property
    def n_virtual(self) -> int:
        """Virtual stage count ``S * v`` (== ``n_stages`` when v=1)."""
        return self.n_stages * self.virtual_per_stage

    def device_of(self, stage: int) -> int:
        """Physical stage (device) owning virtual ``stage`` — Megatron's
        layout: chunk ``stage // S`` lives on device ``stage % S``."""
        return stage % self.n_stages

    @property
    def n_slots(self) -> int:
        return max(t.slot for t in self.ticks) + 1 if self.ticks else 0

    @property
    def fill_drain_slots(self) -> int:
        """Timeline length in fwd+bwd *pairs* — the ``(m + S - 1)``
        fill/drain count the cost model prices."""
        return self.n_slots // 2

    def stage_ticks(self, stage: int) -> list[Tick]:
        return [t for t in self.ticks if t.stage == stage]

    def device_ticks(self, device: int) -> list[Tick]:
        """All ticks on one physical device, across its chunks."""
        return [t for t in self.ticks if self.device_of(t.stage) == device]

    def by_slot(self) -> dict[int, list[Tick]]:
        out: dict[int, list[Tick]] = {}
        for t in self.ticks:
            out.setdefault(t.slot, []).append(t)
        return out

    def peak_in_flight(self, stage: int) -> int:
        """Max microbatches forwarded but not yet backwarded at virtual
        ``stage`` (the activation-memory bound the 1F1B schedule exists
        to cap)."""
        live = peak = 0
        for t in sorted(self.stage_ticks(stage), key=lambda t: t.slot):
            live += 1 if t.phase == "fwd" else -1
            peak = max(peak, live)
        return peak

    def peak_in_flight_device(self, device: int) -> int:
        """Max in-flight microbatch activations held by one DEVICE,
        summed over its ``v`` chunks — the quantity interleaving trades
        against bubble time."""
        live = peak = 0
        for t in sorted(self.device_ticks(device), key=lambda t: t.slot):
            live += 1 if t.phase == "fwd" else -1
            peak = max(peak, live)
        return peak

    def warmup_depth(self, stage: int) -> int:
        """Forward ticks this virtual stage runs before its first
        backward."""
        n = 0
        for t in sorted(self.stage_ticks(stage), key=lambda t: t.slot):
            if t.phase == "bwd":
                break
            n += 1
        return n

    def stats(self, durations: "Mapping[tuple[int, str], float] | None"
              = None) -> ScheduleStats:
        """Accounting of this timetable; ``durations`` maps
        ``(virtual stage, phase) -> seconds`` (default: uniform 1.0, so
        the priced makespan equals the slot count)."""
        m, s = self.num_microbatches, self.n_stages
        boundaries = sum(1 for vs in range(self.n_virtual - 1)
                         if self.device_of(vs) != self.device_of(vs + 1))
        priced = price_schedule(self, durations)
        return ScheduleStats(
            n_ticks=len(self.ticks),
            n_slots=self.n_slots,
            bubbles=s * self.n_slots - len(self.ticks),
            p2p_messages=2 * m * boundaries,
            makespan=priced.makespan,
            bubble_fraction=priced.bubble_fraction)

    def describe(self) -> str:
        v = self.virtual_per_stage
        lines = [f"{self.kind} schedule: {self.n_stages} stage(s)"
                 + (f" x {v} chunk(s)" if v > 1 else "")
                 + f" x {self.num_microbatches} microbatch(es), "
                 + self.stats().summary()]
        by_slot = self.by_slot()
        for dev in range(self.n_stages):
            row = []
            for slot in range(self.n_slots):
                tick = next((t for t in by_slot.get(slot, ())
                             if self.device_of(t.stage) == dev), None)
                if tick is None:
                    row.append("  .   " if v > 1 else "  .  ")
                elif v > 1:
                    chunk = chr(ord("a") + tick.stage // self.n_stages)
                    row.append(f"{tick.phase[0].upper()}"
                               f"{tick.microbatch}{chunk}".ljust(6))
                else:
                    row.append(f"{tick.phase[0].upper()}"
                               f"{tick.microbatch:<3d} ")
            label = f"device {dev}" if v > 1 else f"stage {dev}"
            lines.append(f"  {label}: " + "".join(row))
        return "\n".join(lines)


@dataclass(frozen=True)
class PricedSchedule:
    """A timetable re-timed under per-(virtual stage, phase) durations:
    each tick starts when its device is free AND its dependencies have
    finished (the same list-scheduling rule that generated the slots,
    with real durations)."""

    schedule: PipelineSchedule
    starts: dict          # (stage, microbatch, phase) -> start seconds
    finishes: dict        # (stage, microbatch, phase) -> finish seconds
    makespan: float       # max finish time across all ticks
    busy: dict            # device -> total busy seconds

    @property
    def bubble_fraction(self) -> float:
        """Idle share of total device-time under the priced timetable."""
        if self.makespan <= 0.0:
            return 0.0
        total = self.schedule.n_stages * self.makespan
        return 1.0 - sum(self.busy.values()) / total

    def start(self, stage: int, microbatch: int, phase: str) -> float:
        return self.starts[(stage, microbatch, phase)]

    def finish(self, stage: int, microbatch: int, phase: str) -> float:
        return self.finishes[(stage, microbatch, phase)]


def price_schedule(sched: PipelineSchedule,
                   durations: "Mapping[tuple[int, str], float] | "
                              "Callable[[int, str], float] | None" = None,
                   *,
                   comm: "Mapping[tuple[int, str], float] | "
                         "Callable[[int, str], float] | None" = None,
                   overlap: bool = False) -> PricedSchedule:
    """Re-time ``sched`` under non-uniform tick durations.

    ``durations`` maps ``(virtual stage, phase) -> seconds`` (mapping or
    callable; default uniform 1.0).  Ticks are processed in slot order —
    each starts at ``max(device free, dependency finishes)`` — so with
    uniform durations the makespan equals the slot count exactly, and
    with per-stage costs (``costmodel.pipeline_tick_durations``) the
    makespan is the critical-path time of the timetable the executors
    would actually run.

    ``comm`` optionally maps ``(virtual stage, phase) -> seconds`` of
    communication attributable to the tick (P2P sends plus, on backward
    ticks, eager grad-reduce issue).  A synchronous executor serializes
    it after compute, so each tick costs ``compute + comm``; with
    ``overlap=True`` the tick is priced as the async executor runs it —
    comm streams behind the next tick's compute, so the tick occupies
    ``max(compute, comm)``.  Because ``max(a, b) <= a + b`` for
    non-negative costs, overlap pricing can never exceed sync pricing of
    the same (durations, comm) split.  ``comm=None`` (the default)
    prices exactly as before this knob existed, whatever ``overlap``.
    """
    if durations is None:
        get = lambda s, ph: 1.0                      # noqa: E731
    elif callable(durations):
        get = durations
    else:
        get = lambda s, ph: float(durations[(s, ph)])  # noqa: E731
    if comm is None:
        cget = lambda s, ph: 0.0                     # noqa: E731
    elif callable(comm):
        cget = comm
    else:
        cget = lambda s, ph: float(comm[(s, ph)])    # noqa: E731
    starts: dict = {}
    finishes: dict = {}
    avail: dict[int, float] = {}
    busy: dict[int, float] = {}
    nv = sched.n_virtual
    for t in sched.ticks:                 # (slot, stage) order: deps first
        key = (t.stage, t.microbatch, t.phase)
        deps = []
        if t.phase == "fwd":
            if t.stage > 0:
                deps.append((t.stage - 1, t.microbatch, "fwd"))
        else:
            if t.stage < nv - 1:
                deps.append((t.stage + 1, t.microbatch, "bwd"))
            deps.append((t.stage, t.microbatch, "fwd"))
        dev = sched.device_of(t.stage)
        start = avail.get(dev, 0.0)
        for d in deps:
            if d not in finishes:
                raise ScheduleError(
                    f"cannot price invalid schedule: tick {key} runs "
                    f"before its dependency {d}")
            start = max(start, finishes[d])
        comp = get(t.stage, t.phase)
        cdur = cget(t.stage, t.phase)
        dur = max(comp, cdur) if overlap else comp + cdur
        starts[key] = start
        finishes[key] = start + dur
        avail[dev] = start + dur
        busy[dev] = busy.get(dev, 0.0) + dur
    makespan = max(finishes.values(), default=0.0)
    return PricedSchedule(sched, starts, finishes, makespan, busy)


def _closed_form_ticks(kind: str, s_total: int, m: int) -> list[Tick]:
    """The 1F1B/GPipe closed-form slots (see ``build_schedule``)."""
    ticks: list[Tick] = []
    for s in range(s_total):
        if kind == "gpipe":
            for j in range(m):
                ticks.append(Tick(s + j, s, j, "fwd"))
                ticks.append(Tick(m + 2 * s_total - 2 - s + j, s, j, "bwd"))
        else:  # 1f1b
            warm = min(s_total - 1 - s, m)
            for j in range(m):
                if j < warm:
                    slot = s + j
                else:
                    slot = 2 * s_total - 2 - s + 2 * (j - warm)
                ticks.append(Tick(slot, s, j, "fwd"))
                ticks.append(Tick(2 * s_total - 1 - s + 2 * j, s, j, "bwd"))
    ticks.sort(key=lambda t: (t.slot, t.stage))
    return ticks


def _interleaved_units(s_total: int, v: int,
                       m: int) -> tuple[list, list]:
    """Megatron's virtual-microbatch unit orders: microbatches advance in
    groups of (up to) ``S``; within a group all ``v`` chunks of the group
    run before the next group starts (chunk-major forward, reverse
    chunk-major backward)."""
    fwd: list[tuple[int, int]] = []
    bwd: list[tuple[int, int]] = []
    lo = 0
    while lo < m:
        group = min(s_total, m - lo)
        for c in range(v):
            fwd.extend((c, lo + i) for i in range(group))
        for c in reversed(range(v)):
            bwd.extend((c, lo + i) for i in range(group))
        lo += group
    return fwd, bwd


def _interleaved_ticks(s_total: int, v: int, m: int) -> list[Tick]:
    """Emit the interleaved timetable by list-scheduling Megatron's
    per-device unit order: device ``s`` warms up with
    ``min(2*(S-1-s) + (v-1)*S, m*v)`` forwards, then alternates strictly
    1F1B over virtual units.  A time-stepped greedy assigns slots — each
    device fires its next unit once all dependencies finished in an
    earlier slot — so the result is dependency-valid by construction."""
    fwd_units, bwd_units = _interleaved_units(s_total, v, m)
    orders: list[list[tuple[str, int, int]]] = []
    for s in range(s_total):
        w = min(2 * (s_total - 1 - s) + (v - 1) * s_total, m * v)
        units = [("fwd", c, j) for c, j in fwd_units[:w]]
        for i, (c, j) in enumerate(bwd_units):
            if w + i < len(fwd_units):
                fc, fj = fwd_units[w + i]
                units.append(("fwd", fc, fj))
            units.append(("bwd", c, j))
        orders.append(units)

    ticks: list[Tick] = []
    progress = [0] * s_total
    done: dict[tuple[int, int, str], int] = {}
    n_v = s_total * v
    total = 2 * m * v * s_total
    slot = 0
    while len(ticks) < total:
        fired: list[tuple[int, int, int, str]] = []
        for s in range(s_total):
            if progress[s] >= len(orders[s]):
                continue
            phase, c, j = orders[s][progress[s]]
            vs = c * s_total + s
            if phase == "fwd":
                deps = [(vs - 1, j, "fwd")] if vs > 0 else []
            else:
                deps = [(vs, j, "fwd")]
                if vs < n_v - 1:
                    deps.append((vs + 1, j, "bwd"))
            if all(d in done for d in deps):
                fired.append((s, vs, j, phase))
        if not fired:
            raise ScheduleError(
                f"interleaved schedule deadlocked at slot {slot} "
                f"(S={s_total}, v={v}, m={m})")
        for s, vs, j, phase in fired:
            ticks.append(Tick(slot, vs, j, phase))
            progress[s] += 1
        for _, vs, j, phase in fired:
            done[(vs, j, phase)] = slot
        slot += 1
    ticks.sort(key=lambda t: (t.slot, t.stage))
    return ticks


def build_schedule(n_stages: int, num_microbatches: int,
                   kind: str = "1f1b",
                   virtual_stages_per_device: int = 1) -> PipelineSchedule:
    """Construct the per-stage timetable for ``kind``.

    Closed forms (uniform tick durations; ``S`` stages, ``m``
    microbatches, ``w_s = min(S-1-s, m)`` warmup forwards):

    =====  =========================================  ====================
    kind   fwd(j, s) slot                             bwd(j, s) slot
    =====  =========================================  ====================
    gpipe  ``s + j``                                  ``m + 2S - 2 - s + j``
    1f1b   warmup ``s + j``; steady                   ``2S - 1 - s + 2j``
           ``2S - 2 - s + 2(j - w_s)``
    =====  =========================================  ====================

    Both span ``2 (m + S - 1)`` slots — 1F1B trades nothing in makespan
    (for uniform ticks) but caps in-flight microbatches at the stage
    depth instead of ``m``.

    ``kind="interleaved"`` additionally takes
    ``virtual_stages_per_device`` (Megatron's ``v``): each device holds
    ``v`` model chunks and the timetable runs over ``S*v`` virtual
    stages (``Tick.stage`` is then the virtual index; the device is
    ``stage % S``).  ``v=1`` is exactly the 1F1B table.  Interleaving
    shrinks the fill/drain bubble ~``1/v`` at the price of holding up to
    ``2(S-1) + (v-1)S + 1`` in-flight microbatches per device.
    """
    if kind not in SCHEDULES:
        raise ScheduleError(f"unknown schedule {kind!r} (have {SCHEDULES})")
    if n_stages < 1:
        raise ScheduleError(f"need at least one stage (got {n_stages})")
    if num_microbatches < 1:
        raise ScheduleError(
            f"need at least one microbatch (got {num_microbatches})")
    v = virtual_stages_per_device
    if v < 1:
        raise ScheduleError(
            f"need at least one virtual stage per device (got {v})")
    if kind != "interleaved" and v != 1:
        raise ScheduleError(
            f"virtual_stages_per_device={v} requires kind='interleaved' "
            f"(got {kind!r})")
    s_total, m = n_stages, num_microbatches
    if kind == "interleaved" and v > 1:
        # Megatron's constraint: microbatches advance in groups of S, so
        # a trailing partial group would cross the first group's drain
        # and deadlock the 1F1B alternation.  A single (possibly
        # partial) group never overlaps itself, so m <= S is also fine.
        if m % s_total != 0 and m > s_total:
            raise ScheduleError(
                f"interleaved schedule needs num_microbatches divisible "
                f"by the stage count (or <= it): got m={m}, S={s_total}")
        ticks = _interleaved_ticks(s_total, v, m)
    else:  # 1f1b, gpipe, and interleaved at v=1 (degenerate, same table)
        ticks = _closed_form_ticks("gpipe" if kind == "gpipe" else "1f1b",
                                   s_total, m)
    sched = PipelineSchedule(kind, s_total, m, ticks, virtual_per_stage=v)
    validate(sched)
    return sched


def validate(sched: PipelineSchedule) -> None:
    """Assert the timetable is executable: each device runs one tick per
    slot, forwards follow the previous (virtual) stage, backwards follow
    the next (virtual) stage and the microbatch's own forward."""
    seen: dict[tuple[int, int, str], int] = {}
    busy: set[tuple[int, int]] = set()
    nv = sched.n_virtual
    for t in sched.ticks:
        if not 0 <= t.stage < nv:
            raise ScheduleError(
                f"tick stage {t.stage} out of range for {nv} virtual "
                f"stage(s)")
        key = (t.stage, t.microbatch, t.phase)
        if key in seen:
            raise ScheduleError(f"duplicate tick {key}")
        seen[key] = t.slot
        cell = (sched.device_of(t.stage), t.slot)
        if cell in busy:
            raise ScheduleError(
                f"device {cell[0]} runs two ticks in slot {t.slot}")
        busy.add(cell)
    expect = 2 * nv * sched.num_microbatches
    if len(sched.ticks) != expect:
        raise ScheduleError(
            f"{len(sched.ticks)} ticks scheduled, expected {expect}")

    def slot_of(stage: int, j: int, phase: str) -> int:
        slot = seen.get((stage, j, phase))
        if slot is None:
            raise ScheduleError(
                f"missing tick ({stage}, mb={j}, {phase})")
        return slot

    for (stage, j, phase), slot in seen.items():
        if phase == "fwd":
            if stage > 0 and slot_of(stage - 1, j, "fwd") >= slot:
                raise ScheduleError(
                    f"fwd(mb={j}) at stage {stage} precedes stage "
                    f"{stage - 1}")
        else:
            if stage < nv - 1 and \
                    slot_of(stage + 1, j, "bwd") >= slot:
                raise ScheduleError(
                    f"bwd(mb={j}) at stage {stage} precedes stage "
                    f"{stage + 1}")
            if slot_of(stage, j, "fwd") >= slot:
                raise ScheduleError(
                    f"bwd(mb={j}) at stage {stage} precedes its fwd")


# ---------------------------------------------------------------------------
# microbatch roles over a graph
# ---------------------------------------------------------------------------

def microbatch_roles(graph: Graph, batch_dim: int = 0) -> dict[str, int]:
    """Tensor name -> microbatch role (``op_semantics`` vocabulary):
    placeholders are Split along ``batch_dim``, parameters Duplicate,
    everything else propagates through ``op_semantics.microbatch_role``
    (reshape's split dim is remapped here, where shapes are known)."""
    roles: dict[str, int] = {}
    for op in graph.ops:
        out = op.outputs[0] if op.outputs else None
        if op.kind == "placeholder":
            if len(out.shape) <= batch_dim:
                raise MicrobatchError(
                    f"placeholder {out.name!r} has no batch dim "
                    f"{batch_dim} to split")
            roles[out.name] = batch_dim
            continue
        if op.kind == "parameter":
            roles[out.name] = MB_DUP
            continue
        grad_of = op.attrs.get("grad_of")
        if grad_of is not None:
            # gradient duality: a tensor's grad relates to the batch
            # split exactly as the tensor does, with Duplicate <->
            # Partial swapped (parameters accumulate grad summands
            # across microbatches; the Partial loss seeds an invariant
            # gradient) — op_semantics.cotangent_role
            roles[out.name] = op_semantics.cotangent_role(roles[grad_of])
            continue
        if op.kind == "comm":
            roles[out.name] = roles[op.inputs[0].name]
            continue
        in_roles = [roles[t.name] for t in op.inputs]
        try:
            role = op_semantics.microbatch_role(
                op.kind, in_roles, op.attrs,
                [len(t.shape) for t in op.inputs])
        except MicrobatchError as e:
            raise MicrobatchError(f"{out.name!r}: {e}") from None
        if op.kind == "reshape" and role >= 0:
            role = _map_reshape_dim(role, op.inputs[0].shape,
                                    op.attrs["new_shape"], out.name)
        roles[out.name] = role
    return roles


def _map_reshape_dim(d: int, old_shape, new_shape, name: str) -> int:
    """The batch dim survives a reshape iff the leading-dims product is
    preserved (the same rule annotation deduction uses; symbolic dims
    compare as canonicalized products)."""
    from .symbolic import dims_equal, prod_dims
    before = prod_dims(old_shape[:d])
    acc = 1
    for nd, size in enumerate(new_shape):
        if dims_equal(acc, before):
            return nd
        acc = prod_dims((acc, size))
    raise MicrobatchError(
        f"{name!r}: reshape moves the microbatch (batch) dim {d}")


def microbatch_graph(graph: Graph, num_microbatches: int,
                     roles: dict[str, int] | None = None,
                     shape_env: dict[str, int] | None = None) -> Graph:
    """A deep copy of ``graph`` with every Split-role shape scaled down
    to one microbatch (reshape targets rewritten alongside; symbolic
    dims are bound through ``shape_env`` first).  The copy keeps the
    installed annotations, so it compiles through the normal
    specialization path."""
    import copy

    from .symbolic import bind_shape, free_symbols

    roles = roles if roles is not None else microbatch_roles(graph)
    m = num_microbatches
    micro = copy.deepcopy(graph)
    env = dict(shape_env or {})
    for name, t in micro.tensors.items():
        if free_symbols(t.shape) <= set(env):
            t.shape = bind_shape(t.shape, env)
        d = roles[name]
        if d < 0:
            continue
        size = t.shape[d]
        if not isinstance(size, int):
            raise MicrobatchError(
                f"{name!r}: symbolic batch dim {size!r}; pass shape_env "
                f"to bind it before microbatching")
        if size % m != 0:
            raise MicrobatchError(
                f"{name!r}: batch dim {size} not divisible by "
                f"{m} microbatches")
        t.shape = t.shape[:d] + (size // m,) + t.shape[d + 1:]
    for op in micro.ops:
        if op.kind == "reshape" and roles[op.outputs[0].name] >= 0:
            op.attrs["new_shape"] = tuple(op.outputs[0].shape)
        if op.kind == "bcast":     # sum's VJP: re-aim at the scaled dim
            op.attrs["size"] = op.outputs[0].shape[op.attrs["dim"]]
    return micro


# ---------------------------------------------------------------------------
# op -> stage assignment + output combination
# ---------------------------------------------------------------------------

def _stage_walk(graph: Graph, strategy: int, pipelines: list[Pipeline]
                ) -> tuple[dict[int, int], dict[int, int], int, int]:
    """Walk ``graph.ops`` in program order assigning each op a physical
    stage and an interleave *chunk*.

    The physical stage is the deepest stage any of the op's tensors
    touches (stage-boundary CommOps thereby land with the *sending*
    chunk — the receive completes at the next chunk's first tick).  The
    chunk index counts how many times the dataflow has wrapped from a
    deep stage back to a shallower one: a graph that traverses the
    device ring ``v`` times (Megatron's interleaved layer assignment)
    yields chunks ``0..v-1``.  Leaf ops (placeholders/parameters) stay
    in chunk 0 — they are state, not scheduled work — and do not
    advance the walk.

    Backward ops (autodiff; ``op.attrs["phase"] == "bwd"``) do not
    advance the walk either — their dataflow traverses the ring in
    REVERSE, which would otherwise read as spurious wrap-arounds.  Each
    backward op instead inherits the (stage, chunk) of its forward
    anchor (``op.attrs["fwd_anchor"]``, the forward tensor whose VJP
    produced it): a stage's bwd tick runs exactly the backward of the
    ops its fwd tick ran.

    Returns ``(phys, chunk, n_stages, n_chunks)`` with ``phys`` /
    ``chunk`` keyed by ``id(op)``.
    """
    dev_stage: dict[int, int] = {}
    n_stages = 1
    for p in pipelines:
        n_stages = max(n_stages, p.n_stages)
        for d in p.devices():
            s = p.stage_of(d)
            dev_stage[d] = max(dev_stage.get(d, 0), s)
    phys: dict[int, int] = {}
    chunk: dict[int, int] = {}
    cur_stage = 0
    cur_chunk = 0
    for op in graph.ops:
        if op.attrs.get("phase") == "bwd":
            continue               # anchored below, after the fwd walk
        stages = [dev_stage.get(d, 0)
                  for t in op.inputs + op.outputs
                  for d in t.annots[strategy].devices]
        s = max(stages, default=0)
        phys[id(op)] = s
        if op.kind in ("placeholder", "parameter"):
            chunk[id(op)] = 0
            continue
        if s < cur_stage:          # dataflow wrapped around the ring
            cur_chunk += 1
        cur_stage = s
        chunk[id(op)] = cur_chunk
    for op in graph.ops:
        if op.attrs.get("phase") != "bwd":
            continue
        anchor = op.attrs.get("fwd_anchor")
        aop = graph.tensors[anchor].producer if anchor else None
        if aop is not None and id(aop) in phys:
            phys[id(op)] = phys[id(aop)]
            chunk[id(op)] = chunk[id(aop)]
        else:
            phys[id(op)] = 0
            chunk[id(op)] = 0
    return phys, chunk, n_stages, cur_chunk + 1


def infer_virtual_stages(graph: Graph, strategy: int,
                         pipelines: list[Pipeline]) -> int:
    """How many model chunks per device this graph's dataflow makes
    (Megatron's ``v``): 1 + the number of times program order wraps from
    a deep pipeline stage back to a shallower one.  ``v > 1`` graphs can
    only be scheduled with ``kind="interleaved"``."""
    return _stage_walk(graph, strategy, pipelines)[3]


def assign_stages(graph: Graph, strategy: int,
                  pipelines: list[Pipeline],
                  virtual_stages_per_device: int = 1) -> dict[int, int]:
    """Map ``id(op) -> (virtual) stage index``.  A device's stage is its
    position in its pipeline; an op runs at the deepest stage any of its
    tensors touches, so a *forward* stage-boundary CommOp lands on the
    receiving stage (the activation send completes the hop), while a
    *wrap-around* CommOp (deep stage back to a shallow one) lands on the
    sending stage — its receive completes at the next chunk's first
    tick (see ``_stage_walk``).

    With ``virtual_stages_per_device = v > 1`` ops are additionally
    bucketed into interleave chunks (``_stage_walk``): an op in chunk
    ``c`` at physical stage ``s`` runs at virtual stage ``c*S + s`` —
    the tick indices ``build_schedule(kind="interleaved")`` emits.
    Raises if the graph wraps more times than ``v`` allows."""
    phys, chunk, n_stages, n_chunks = _stage_walk(graph, strategy,
                                                  pipelines)
    v = virtual_stages_per_device
    if n_chunks > v:
        raise ScheduleError(
            f"graph dataflow makes {n_chunks} chunk(s) per device but "
            f"virtual_stages_per_device={v}; schedule it with "
            f"kind='interleaved' and v >= {n_chunks}")
    out: dict[int, int] = {}
    for op in graph.ops:
        out[id(op)] = chunk[id(op)] * n_stages + phys[id(op)]
    return out


def combine_outputs(per_mb: list[dict], roles: dict[str, int],
                    full_shapes: dict[str, tuple[int, ...]],
                    full_annots: dict[str, object]) -> dict:
    """Reduce per-microbatch fetches to full-batch ShardedTensors.

    Partial -> sequential per-shard sum in microbatch order (both
    executors' per-microbatch shards are bit-exact, so the combined
    shards are too); Duplicate -> microbatch 0's shards; Split(d) ->
    gather each microbatch globally, concatenate along ``d`` and
    re-scatter under the full-batch annotation.
    """
    from .simulator import ShardedTensor, gather, scatter

    out: dict[str, ShardedTensor] = {}
    for name in per_mb[0]:
        role = roles[name]
        shards = [r[name] for r in per_mb]
        annot = full_annots[name]
        if role == MB_PARTIAL:
            parts = {d: a.copy() for d, a in shards[0].parts.items()}
            for st in shards[1:]:
                for d in parts:
                    parts[d] = parts[d] + st.parts[d]
            out[name] = ShardedTensor(full_shapes[name], annot, parts)
        elif role == MB_DUP:
            out[name] = ShardedTensor(full_shapes[name], annot,
                                      dict(shards[0].parts))
        else:
            if annot.has_partial:
                raise MicrobatchError(
                    f"cannot reconstruct Split-role fetch {name!r} under "
                    f"a Partial annotation; fetch the reduced value "
                    f"instead")
            full = np.concatenate([gather(s) for s in shards], axis=role)
            out[name] = scatter(full, annot)
    return out


__all__ = [
    "PipelineSchedule", "PricedSchedule", "ScheduleError", "ScheduleStats",
    "Tick", "SCHEDULES", "assign_stages", "build_schedule",
    "combine_outputs", "infer_virtual_stages", "microbatch_graph",
    "microbatch_roles", "price_schedule", "validate",
]

# re-exported for callers reasoning about roles without op_semantics
assert (MB_DUP, MB_PARTIAL) == (DUP, PARTIAL)
