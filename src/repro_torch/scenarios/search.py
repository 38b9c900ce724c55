"""Heterogeneous strategy search over the cluster cost model.

The paper (§7.2) selects strategies from "pre-profiled results combined
with a cost model"; related work (Metis, HexiScale) searches the hetero
strategy space.  This module is now a thin compatibility shim over the
:mod:`repro_torch.search` subsystem (enumerate -> prune -> rank -> validate):
the old entry points keep their signatures, but enumeration and pruning
live in :mod:`repro_torch.search.space` / :mod:`repro_torch.search.prune`, and an
infeasible search raises :class:`repro_torch.search.SearchError` (a
``RuntimeError`` subclass) carrying per-rule rejection counts instead
of a bare message.
"""

from __future__ import annotations

from repro_torch.core.costmodel import ClusterSpec, ModelSpec, Strategy
from repro_torch.search.prune import PruneReport, SearchError, prune
from repro_torch.search.rank import rank
from repro_torch.search.space import balanced_stages, enumerate_candidates

# The old private helper had an off-by-one that could emit zero-layer
# stages when the group count approached the layer count; it is now an
# alias of the fixed implementation (every stage gets >= 1 layer).
_balanced_stages = balanced_stages


def search_hetero_strategy(cluster: ClusterSpec, model: ModelSpec,
                           ranks: list[int], global_batch: int,
                           seq_len: int,
                           n_pipelines_options=(1, 2, 4),
                           tp_options=(2, 4, 8, 16)) -> tuple[Strategy, float]:
    """Best hetero strategy found; raises :class:`SearchError` (a
    ``RuntimeError``) with per-rule rejection counts if nothing is
    feasible.  Kept signature-compatible with the pre-subsystem
    searcher: ``n_micro = max(global_batch // n_pipelines, 1)`` and the
    analytic fwd/bwd split (so returned times stay comparable to
    ``best_uniform``'s ``step_time``)."""
    best: tuple[Strategy, float] | None = None
    n_cands, rejections = 0, []
    for n_pipes in sorted(n_pipelines_options):
        # the old searcher tolerated non-divisible global batches by
        # rounding the per-pipeline microbatch count up to >= 1
        gb = n_pipes * max(global_batch // n_pipes, 1)
        cands = enumerate_candidates(
            cluster, model, list(ranks), global_batch=gb,
            tp_options=tp_options, pipeline_options=(n_pipes,),
            include_uniform=False)
        report = prune(cluster, model, cands)
        n_cands += report.n_candidates
        rejections.extend(report.rejections)
        if not report.survivors:
            continue
        top = rank(cluster, model, report.survivors, seq_len,
                   fwd_fraction=None)[0]
        if best is None or top.predicted_step_s < best[1]:
            best = (top.candidate.strategy, top.predicted_step_s)
    if best is None:
        raise SearchError(
            PruneReport(n_cands, (), tuple(rejections)),
            "heterogeneous strategy")
    return best


def schedule_report(strat: Strategy, cluster: ClusterSpec | None = None,
                    model: ModelSpec | None = None,
                    seq_len: int = 4096) -> str:
    """Per-pipeline 1F1B/GPipe timetable stats for a found strategy —
    the executable (`core.schedule`) counterpart of the term `step_time`
    prices, so searches can report the bubble shape their winner
    actually runs.  With ``cluster`` + ``model`` the ticks are priced
    per (stage, phase) from the cost model (non-uniform durations);
    otherwise the makespan is in uniform slots."""
    from repro_torch.core.costmodel import pipeline_tick_durations
    from repro_torch.core.schedule import build_schedule

    lines = []
    for i, p in enumerate(strat.pipelines):
        s = build_schedule(len(p.stages), p.n_micro, strat.schedule)
        durations = None
        if cluster is not None and model is not None:
            durations = pipeline_tick_durations(cluster, model, p, seq_len)
        lines.append(f"pipeline {i} [{strat.schedule}]: "
                     f"{s.stats(durations).summary()}")
    return "\n".join(lines)
