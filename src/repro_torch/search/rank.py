"""Rank surviving candidates with the priced pipeline cost model.

Each survivor is scored by ``costmodel.step_time`` — the slowest
pipeline's priced timetable (``pipeline_time`` builds the actual
1F1B/interleaved tick table and re-times it) plus cross-pipeline grad
sync.  The fwd/bwd tick split defaults to a MEASURED fraction
(``fwd_fraction="measured"``): a tiny differentiated proxy program is
compiled once and its :meth:`CompiledPlan.fwd_fraction` replaces the
analytic 1/3 assumption, module-memoized so ranking stays cheap.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.costmodel import (ClusterSpec, ModelSpec,
                                        dp_sync_time, pipeline_time)

from .space import Candidate

# measured fwd fraction of the differentiated proxy, computed once per
# process (the ratio is a property of the op mix, not of the cluster)
_PROXY_FRACTION: list[float] = []


def proxy_fwd_fraction() -> float:
    """The fwd share of a differentiated relu-MLP step, measured from a
    single-device ``compile_train`` proxy plan (memoized)."""
    if not _PROXY_FRACTION:
        from repro_torch import api
        g = api.Graph()
        g.placeholder("X", (4, 8))
        g.parameter("W", (8, 8))
        y = g.relu(g.dot(g.tensors["X"], g.tensors["W"], name="H"),
                   name="Y")
        g.sum(g.sum(y, 1, name="L1"), 0, name="L")
        strat = api.Strategy("proxy", {
            "X": api.spmd([0], api.DS({})),
            "W": api.spmd([0], api.DS({})),
        })
        plan = api.Program(g, [strat]).compile_train("proxy")
        _PROXY_FRACTION.append(plan.fwd_fraction())
    return _PROXY_FRACTION[0]


def resolve_fwd_fraction(spec: float | str | None) -> float | None:
    """``None`` -> analytic 1/3; ``"measured"`` -> proxy-measured;
    a float passes through."""
    if spec is None:
        return None
    if spec == "measured":
        return proxy_fwd_fraction()
    return float(spec)


@dataclass(frozen=True)
class RankedCandidate:
    candidate: Candidate
    predicted_step_s: float
    pipeline_s: float
    sync_s: float
    fwd_fraction: float | None      # None = analytic split

    @property
    def name(self) -> str:
        return self.candidate.name

    def describe(self) -> str:
        return (f"{self.name}: {self.predicted_step_s * 1e3:.3f} ms "
                f"(pipeline {self.pipeline_s * 1e3:.3f} + "
                f"sync {self.sync_s * 1e3:.3f})")


def predict_step_time(cluster: ClusterSpec, model: ModelSpec,
                      cand: Candidate, seq_len: int, *,
                      fwd_fraction: float | None = None,
                      overlap: bool = False) -> RankedCandidate:
    strat = cand.strategy
    assert strat is not None, f"cannot price rejected {cand.name}"
    kind = "interleaved" if cand.v > 1 else cand.schedule
    t_pipe = max(pipeline_time(
        cluster, model, p, seq_len, kind=kind,
        virtual_stages_per_device=cand.v, fwd_fraction=fwd_fraction,
        overlap=overlap)
        for p in strat.pipelines)
    t_sync = dp_sync_time(cluster, model, strat)
    return RankedCandidate(cand, t_pipe + t_sync, t_pipe, t_sync,
                           fwd_fraction)


def rank(cluster: ClusterSpec, model: ModelSpec,
         candidates: list[Candidate] | tuple[Candidate, ...],
         seq_len: int, *,
         fwd_fraction: float | str | None = "measured",
         overlap: bool = False) -> list[RankedCandidate]:
    """Survivors sorted fastest-first (name breaks exact ties, keeping
    the order deterministic).  ``overlap=True`` scores candidates for
    the async executor: boundary transfers are priced ``max(compute,
    comm)`` per tick instead of serialized after compute — pipelines
    whose boundaries the async runtime can hide rank accordingly."""
    frac = resolve_fwd_fraction(fwd_fraction)
    ranked = [predict_step_time(cluster, model, c, seq_len,
                                fwd_fraction=frac, overlap=overlap)
              for c in candidates]
    ranked.sort(key=lambda rc: (rc.predicted_step_s, rc.name))
    return ranked
