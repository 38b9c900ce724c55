"""The trace-driven elastic training driver: the port's copy of
``repro/elastic/driver.py``.  Given no executor its sessions run on
``TorchExecutor()`` (``cuda``, raising without a GPU), and each switch
migrates weights and AdamW m/v on that device.

Runs a REAL training loop over a ``(step -> device set)`` trace.  On
every transition it asks a *provider* for the new device set's strategy
(plug in :class:`repro_torch.elastic.fixtures.SearchProvider` to re-select
through ``repro_torch.search.Searcher`` mid-run), migrates weights AND AdamW
m/v restart-free through ``Session.switch`` (fused-BSR plan), and keeps
issuing ``train_step``\\ s on the surviving logical batch schedule —
bit-identically to an uninterrupted single-strategy run (see
:mod:`repro_torch.elastic.fixtures` for why that oracle is exact).

A :class:`~repro_torch.elastic.faults.FaultPlan` injects device loss/join at
trace-specified steps — including *mid-transition* (the driver
re-selects and migrates a second time from the just-switched state) and
*between a checkpoint and the next step* (``crash`` faults: the run
returns ``interrupted_at`` and :meth:`ElasticDriver.resume` restores
from the latest durable checkpoint, under whatever device set is then
alive — a DIFFERENT topology than the one that saved).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from repro_torch import api
from repro_torch.checkpoint import store
from repro_torch.checkpoint.store import CheckpointError
from repro_torch.core.simulator import gather
from repro_torch.core.switching import SwitchReport
from repro_torch.tree import tree_map

from .faults import FaultError, FaultPlan


class ElasticError(RuntimeError):
    """The driver cannot make progress (empty trace, no devices, no
    checkpoint to resume from, ...)."""


@dataclass(frozen=True)
class TraceEvent:
    """At ``step`` (before it runs), the cluster becomes ``ranks``.
    ``layout`` optionally pins the provider's strategy class — same
    ranks + a new layout is a *class-change* transition."""

    step: int
    ranks: tuple[int, ...]
    layout: str | None = None

    def __post_init__(self):
        object.__setattr__(self, "ranks", tuple(self.ranks))


@dataclass
class StepRecord:
    step: int
    loss: float
    strategy: str
    ranks: tuple[int, ...]
    wall_seconds: float


@dataclass
class TransitionRecord:
    """One strategy transition: what triggered it, how it was
    classified, and the consumed :class:`SwitchReport` (wall seconds,
    fused-BSR bytes/messages) plus the provider's selection time."""

    step: int
    kind: str                        # shrink | grow | class-change | no-op | resize
    trigger: str                     # trace | fault | mid-transition | resume
    report: SwitchReport
    select_seconds: float
    src_ranks: tuple[int, ...]
    dst_ranks: tuple[int, ...]

    def describe(self) -> str:
        return (f"step {self.step}: {self.kind} ({self.trigger}) "
                f"{list(self.src_ranks)} -> {list(self.dst_ranks)} "
                f"[{self.report.summary()}, "
                f"wall {self.report.wall_seconds * 1e3:.1f} ms, "
                f"select {self.select_seconds * 1e3:.1f} ms]")


@dataclass
class ElasticRun:
    """One driver run (or resumed continuation)."""

    steps: list[StepRecord] = field(default_factory=list)
    transitions: list[TransitionRecord] = field(default_factory=list)
    checkpoints: list[tuple[int, str]] = field(default_factory=list)
    interrupted_at: int | None = None   # crash fault fired before this step
    resumed_from: tuple[int, str] | None = None

    @property
    def losses(self) -> list[float]:
        return [s.loss for s in self.steps]

    def transition_kinds(self) -> list[str]:
        return [t.kind for t in self.transitions]

    def summary(self) -> str:
        lines = [f"{len(self.steps)} step(s), "
                 f"{len(self.transitions)} transition(s), "
                 f"{len(self.checkpoints)} checkpoint(s)"
                 + (f", interrupted at step {self.interrupted_at}"
                    if self.interrupted_at is not None else "")
                 + (f", resumed from step {self.resumed_from[0]}"
                    if self.resumed_from else "")]
        lines += ["  " + t.describe() for t in self.transitions]
        return "\n".join(lines)


def classify_transition(src_ranks, dst_ranks, src_name: str,
                        dst_name: str) -> str:
    """shrink / grow / resize by device-set containment; same set is a
    class-change (new strategy) or a no-op (same strategy)."""
    old, new = set(src_ranks), set(dst_ranks)
    if old == new:
        return "no-op" if src_name == dst_name else "class-change"
    if new < old:
        return "shrink"
    if old < new:
        return "grow"
    return "resize"


def latest_checkpoint(ckpt_dir: str):
    """``(path, manifest)`` of the newest COMPLETE checkpoint under
    ``ckpt_dir`` (``step-NNNNNN`` directories; half-written temp dirs
    and corrupted saves are skipped), or ``None``."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.startswith("step-"):
            continue
        path = os.path.join(ckpt_dir, name)
        try:
            manifest = store.peek(path)
        except CheckpointError:
            continue
        if best is None or manifest["step"] > best[1]["step"]:
            best = (path, manifest)
    return best


class ElasticDriver:
    """Trace-driven elastic training over one graph.

    ``provider(ranks, layout=None) -> api.Strategy`` maps a live device
    set to a strategy (see :func:`repro_torch.elastic.fixtures.probe_provider`
    / :class:`repro_torch.elastic.fixtures.SearchProvider`).  ``feeds(step)``
    yields the step's placeholder feeds — the LOGICAL batch schedule,
    independent of which devices are alive.
    """

    def __init__(self, graph: "api.Graph",
                 values: Mapping[str, np.ndarray],
                 provider: Callable[..., "api.Strategy"],
                 feeds: Callable[[int], Mapping[str, np.ndarray]], *,
                 executor=None, shape_env=None, topology=None,
                 num_microbatches: int = 1, schedule: str = "1f1b",
                 checkpoint_every: int = 0, ckpt_dir: str | None = None,
                 faults: FaultPlan | None = None, optimizer=None,
                 seed: int = 0):
        if checkpoint_every and not ckpt_dir:
            raise ElasticError("checkpoint_every needs ckpt_dir")
        self.graph = graph
        self.values = {k: np.asarray(v) for k, v in values.items()}
        self.provider = provider
        self.feeds = feeds
        self.executor = executor
        self.shape_env = dict(shape_env or {})
        self.topology = topology
        self.num_microbatches = num_microbatches
        self.schedule = schedule
        self.checkpoint_every = checkpoint_every
        self.ckpt_dir = ckpt_dir
        self.faults = faults or FaultPlan()
        self.optimizer = optimizer
        self.seed = seed
        self.session: "api.Session | None" = None
        self.ranks: tuple[int, ...] = ()

    # -- state -------------------------------------------------------------
    @property
    def strategy_name(self) -> str:
        return self.session.strategy.name if self.session else ""

    def weight_value(self, name: str) -> np.ndarray:
        return self.session.weight_value(name)

    def state_tree(self) -> dict:
        """The gathered (sharding-agnostic) full state: weights plus —
        once training has stepped — AdamW m/v and the step count."""
        sess = self.session
        tree: dict = {"weights": {n: gather(st)
                                  for n, st in sess.weights.items()}}
        if sess.opt_state is not None:
            tree["opt"] = {
                "m": {n: gather(st)
                      for n, st in sess.opt_state["m"].items()},
                "v": {n: gather(st)
                      for n, st in sess.opt_state["v"].items()},
                "count": np.asarray(sess.opt_state["count"],
                                    dtype=np.int64),
            }
        return tree

    # -- trace execution ---------------------------------------------------
    def run(self, trace: Iterable, n_steps: int) -> ElasticRun:
        """Execute steps ``0..n_steps-1`` under ``trace`` (TraceEvents or
        ``(step, ranks[, layout])`` tuples) + the fault plan.  Returns
        early (``interrupted_at`` set) when a crash fault fires."""
        events = self._normalize(trace)
        if 0 not in events:
            raise ElasticError("trace must set the device set at step 0")
        self.session = None
        self.ranks = ()
        return self._loop(events, 0, n_steps)

    def resume(self, trace: Iterable, n_steps: int, *,
               ranks=None, layout: str | None = None) -> ElasticRun:
        """Restore the latest durable checkpoint and continue to
        ``n_steps``.  The restore topology is ``ranks`` when given (the
        devices alive NOW — typically different from the saver's),
        otherwise the trace+faults' effective set at the checkpoint
        step.  Steps between the checkpoint and the interruption are
        deterministically replayed."""
        found = latest_checkpoint(self.ckpt_dir or "")
        if found is None:
            raise ElasticError(
                f"no complete checkpoint under {self.ckpt_dir!r}")
        path, manifest = found
        step0 = int(manifest["step"])
        events = self._normalize(trace)
        if ranks is None:
            from .faults import inject
            ranks = inject(events.values(), self.faults,
                           step0 + 1)[step0]
        skeleton: dict = {"weights": {n: np.zeros_like(v)
                                      for n, v in self.values.items()}}
        if manifest["meta"].get("has_opt"):
            skeleton["opt"] = {
                "m": {n: np.zeros_like(v)
                      for n, v in self.values.items()},
                "v": {n: np.zeros_like(v)
                      for n, v in self.values.items()},
                "count": np.zeros((), np.int64),
            }
        # the port's store restores into tensors: host ones, read back as
        # numpy, the session's state format
        tree, _ = store.restore(path, tree_map(
            lambda a: torch.from_numpy(np.zeros_like(a)), skeleton))
        tree = tree_map(lambda t: t.numpy(), tree)
        self.session = None
        self._start(tuple(ranks), layout)
        self.session.load(tree["weights"])
        if "opt" in tree:
            sess = self.session
            self.session.opt_state = {
                "m": {n: sess._shard(n, v)
                      for n, v in tree["opt"]["m"].items()},
                "v": {n: sess._shard(n, v)
                      for n, v in tree["opt"]["v"].items()},
                "count": int(tree["opt"]["count"]),
            }
        run = self._loop(events, step0, n_steps)
        run.resumed_from = (step0, path)
        return run

    # -- internals ----------------------------------------------------------
    @staticmethod
    def _normalize(trace) -> dict[int, TraceEvent]:
        events: dict[int, TraceEvent] = {}
        for e in trace:
            if not isinstance(e, TraceEvent):
                e = TraceEvent(*e)
            events[e.step] = e
        return events

    def _start(self, ranks: tuple[int, ...], layout: str | None) -> None:
        strategy = self.provider(ranks, layout)
        program = api.Program(self.graph, [strategy])
        self.session = api.Session(
            program, strategy.name, executor=self.executor,
            shape_env=self.shape_env, topology=self.topology,
            seed=self.seed, optimizer=self.optimizer)
        self.session.load(self.values)
        self.ranks = tuple(ranks)

    def _transition(self, step: int, target: tuple[int, ...],
                    layout: str | None, trigger: str,
                    run: ElasticRun) -> None:
        t0 = time.perf_counter()
        strategy = self.provider(target, layout)
        select_s = time.perf_counter() - t0
        kind = classify_transition(self.ranks, target,
                                   self.strategy_name, strategy.name)
        report = self.session.switch(strategy)
        run.transitions.append(TransitionRecord(
            step, kind, trigger, report, select_s,
            src_ranks=self.ranks, dst_ranks=tuple(target)))
        self.ranks = tuple(target)

    def _checkpoint(self, step: int) -> str:
        path = os.path.join(self.ckpt_dir, f"step-{step:06d}")
        tree = self.state_tree()
        store.save(path, tree, step=step,
                   meta={"ranks": list(self.ranks),
                         "strategy": self.strategy_name,
                         "has_opt": "opt" in tree})
        return path

    def _loop(self, events: dict[int, TraceEvent], start: int,
              n_steps: int) -> ElasticRun:
        run = ElasticRun()
        for step in range(start, n_steps):
            # 1. pre-step faults, then the trace event (absolute)
            target = self.faults.apply(step, "pre-step", self.ranks)
            faulted = target != self.ranks
            layout = None
            ev = events.get(step)
            if ev is not None:
                target, layout = ev.ranks, ev.layout
            if not target:
                raise FaultError(f"no devices alive at step {step}")
            if self.session is None:
                self._start(target, layout)
            elif target != self.ranks or layout is not None:
                self._transition(step, target, layout,
                                 "fault" if faulted and ev is None
                                 else "trace", run)
            # 2. faults landing while the transition was in flight:
            #    re-select and migrate AGAIN from the just-switched state
            mid = self.faults.apply(step, "mid-transition", self.ranks)
            if mid != self.ranks:
                if not mid:
                    raise FaultError(
                        f"no devices alive mid-transition at step {step}")
                self._transition(step, mid, None, "mid-transition", run)
            # 3. durable checkpoint of the state BEFORE this step
            if (self.checkpoint_every and step > start
                    and step % self.checkpoint_every == 0):
                path = self._checkpoint(step)
                run.checkpoints.append((step, path))
                if self.faults.crashes_at(step):
                    run.interrupted_at = step
                    return run
            # 4. one real training step on the logical batch schedule
            t0 = time.perf_counter()
            result = self.session.train_step(
                dict(self.feeds(step)),
                num_microbatches=self.num_microbatches,
                schedule=self.schedule)
            run.steps.append(StepRecord(
                step, result.loss, self.strategy_name, self.ranks,
                time.perf_counter() - t0))
        return run


__all__ = ["ElasticDriver", "ElasticError", "ElasticRun", "StepRecord",
           "TraceEvent", "TransitionRecord", "classify_transition",
           "latest_checkpoint"]
