"""Fault injection for the elastic trace driver.

A :class:`FaultPlan` is a declarative list of :class:`Fault`\\ s — device
kills / joins / process crashes pinned to a step AND a phase of the
driver loop:

* ``"pre-step"`` — the fault lands before step ``step`` begins (the
  driver sees it when it computes the step's device set).
* ``"mid-transition"`` — the fault lands while step ``step``'s strategy
  transition is in flight: the driver has already re-selected and
  migrated once, and must re-select AND migrate again from the
  just-switched state.
* ``"post-checkpoint"`` — (``kind="crash"`` only) the process dies right
  after step ``step``'s checkpoint hits disk and before the step runs —
  the classic lost-progress window the resume path must cover.

:func:`inject` is the *pure* half the differential tests lean on: it
folds a trace and a FaultPlan into the effective ``step -> device set``
map, without running anything.
"""

from __future__ import annotations

from dataclasses import dataclass, field

KINDS = ("kill", "join", "crash")
PHASES = ("pre-step", "mid-transition", "post-checkpoint")


class FaultError(ValueError):
    """A malformed fault specification."""


@dataclass(frozen=True)
class Fault:
    step: int
    kind: str                       # "kill" | "join" | "crash"
    ranks: tuple[int, ...] = ()
    phase: str = "pre-step"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise FaultError(f"unknown fault kind {self.kind!r}; "
                             f"have {KINDS}")
        if self.phase not in PHASES:
            raise FaultError(f"unknown fault phase {self.phase!r}; "
                             f"have {PHASES}")
        if self.kind == "crash":
            if self.phase != "post-checkpoint":
                raise FaultError(
                    "crash faults model the checkpoint-to-step window; "
                    "use phase='post-checkpoint'")
        elif not self.ranks:
            raise FaultError(f"{self.kind} fault needs ranks")
        object.__setattr__(self, "ranks", tuple(self.ranks))


@dataclass(frozen=True)
class FaultPlan:
    faults: tuple[Fault, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    def at(self, step: int, phase: str) -> list[Fault]:
        return [f for f in self.faults
                if f.step == step and f.phase == phase]

    def apply(self, step: int, phase: str, active) -> tuple[int, ...]:
        """The device set after this (step, phase)'s kills/joins land.
        Deterministic: kills drop, joins append (deduplicated), order of
        surviving ranks is preserved."""
        out = list(active)
        for f in self.at(step, phase):
            if f.kind == "kill":
                out = [r for r in out if r not in f.ranks]
            elif f.kind == "join":
                out += [r for r in f.ranks if r not in out]
        return tuple(out)

    def crashes_at(self, step: int) -> bool:
        return any(f.kind == "crash" for f in
                   self.at(step, "post-checkpoint"))


def inject(trace, plan: FaultPlan | None,
           n_steps: int) -> dict[int, tuple[int, ...]]:
    """Fold ``trace`` (TraceEvents or ``(step, ranks)`` pairs) and a
    :class:`FaultPlan` into the effective ``step -> active device set``
    map for steps ``0..n_steps-1`` — the oracle side of the driver's
    fault handling.  Trace events are ABSOLUTE (they reset prior kills);
    faults are deltas on top."""
    plan = plan or FaultPlan()
    events: dict[int, tuple[int, ...]] = {}
    for e in trace:
        if hasattr(e, "step"):
            events[int(e.step)] = tuple(e.ranks)
        else:
            step, ranks = e[0], e[1]
            events[int(step)] = tuple(ranks)
    if 0 not in events:
        raise FaultError("trace must set the device set at step 0")
    out: dict[int, tuple[int, ...]] = {}
    active: tuple[int, ...] = ()
    for step in range(n_steps):
        active = plan.apply(step, "pre-step", active)
        if step in events:
            active = events[step]
        active = plan.apply(step, "mid-transition", active)
        if not active:
            raise FaultError(f"no devices alive at step {step}")
        out[step] = active
    return out


__all__ = ["Fault", "FaultError", "FaultPlan", "KINDS", "PHASES",
           "inject"]
