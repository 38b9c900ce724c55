"""The search driver: enumerate -> prune -> rank -> (optionally)
execution-validate, behind one restart-free entry point.

A :class:`Searcher` holds ONLY model-and-grid configuration — never
cluster state — so the elastic driver (ROADMAP item 3) can call
``searcher.search(new_cluster)`` after every topology change without
rebuilding anything; the measured fwd-fraction proxy is memoized at
module level (it is a property of the op mix, not the cluster).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.costmodel import ClusterSpec, ModelSpec

from .prune import PruneReport, SearchError, prune
from .rank import RankedCandidate, rank, resolve_fwd_fraction
from .space import Candidate, enumerate_candidates
from .validate import ValidationReport, validate


@dataclass
class SearchResult:
    ranked: list[RankedCandidate]
    prune_report: PruneReport
    validation: ValidationReport | None = None

    @property
    def best(self) -> RankedCandidate:
        return self.ranked[0]

    def summary(self) -> str:
        lines = [self.prune_report.summary()]
        lines += ["  " + rc.describe() for rc in self.ranked[:5]]
        if len(self.ranked) > 5:
            lines.append(f"  ... {len(self.ranked) - 5} more")
        if self.validation is not None:
            lines.append(self.validation.summary())
        return "\n".join(lines)


@dataclass
class Selection:
    """Outcome of one mid-run re-selection (:meth:`Searcher.
    select_candidate`): the winning cost-model strategy, its predicted
    step time, and where it came from — a searched candidate, or one of
    the caller's pre-built ``extras``."""

    strategy: object                 # repro.core.costmodel.Strategy
    predicted_step_s: float
    candidate: Candidate | None = None   # set when a searched one won
    extra_index: int | None = None       # set when an extras entry won
    searched: int = 0                    # ranked candidates considered

    @property
    def source(self) -> str:
        return "search" if self.candidate is not None else "extra"


@dataclass
class Searcher:
    """Reusable search configuration for one model.

    ``search(cluster)`` may be called with a DIFFERENT ``ClusterSpec``
    every time (elastic topology changes): nothing cluster-specific is
    cached on the instance.
    """

    model: ModelSpec
    global_batch: int
    seq_len: int = 4096
    tp_options: tuple = (1, 2, 4, 8)
    pp_options: tuple = (1, 2, 4, 8)
    virtual_options: tuple = (1, 2)
    micro_bs_options: tuple = (1,)
    pipeline_options: tuple = (1, 2, 4)
    include_uniform: bool = True
    include_hetero: bool = True
    fwd_fraction: float | str | None = "measured"
    mem_fraction: float = 0.85

    def candidates(self, cluster: ClusterSpec,
                   ranks: list[int] | None = None) -> list[Candidate]:
        return enumerate_candidates(
            cluster, self.model, ranks, global_batch=self.global_batch,
            tp_options=self.tp_options, pp_options=self.pp_options,
            virtual_options=self.virtual_options,
            micro_bs_options=self.micro_bs_options,
            pipeline_options=self.pipeline_options,
            include_uniform=self.include_uniform,
            include_hetero=self.include_hetero)

    def search(self, cluster: ClusterSpec,
               ranks: list[int] | None = None, *,
               validate_top: int = 0, executors=("sim",), device=None,
               mesh=None, repeats: int = 3, what: str = "strategy",
               **validate_kw) -> SearchResult:
        """Enumerate + prune + rank; with ``validate_top=k > 0`` also
        execute the top-k (``validate.validate``).  Raises
        :class:`SearchError` when every candidate is pruned."""
        report = prune(cluster, self.model, self.candidates(cluster,
                                                            ranks),
                       mem_fraction=self.mem_fraction)
        if not report.survivors:
            raise SearchError(report, what)
        ranked = rank(cluster, self.model, report.survivors,
                      self.seq_len, fwd_fraction=self.fwd_fraction)
        validation = None
        if validate_top > 0:
            validation = validate(cluster, ranked, top_k=validate_top,
                                  executors=executors, device=device,
                                  mesh=mesh, repeats=repeats, **validate_kw)
        return SearchResult(ranked, report, validation)

    def select_candidate(self, cluster: ClusterSpec,
                         ranks: list[int] | None = None, *,
                         extras=()) -> Selection:
        """Best cost-model :class:`Strategy` among the searched
        candidates AND any ``extras`` (pre-built strategies, e.g. the
        elastic scenario's hand-written fixture) — the mid-run
        re-selection hook, with provenance (what won and why) for the
        elastic trace driver's transition records."""
        from repro_torch.core.costmodel import step_time

        frac = resolve_fwd_fraction(self.fwd_fraction)
        sel: Selection | None = None
        searched = 0
        try:
            result = self.search(cluster, ranks)
            searched = len(result.ranked)
            sel = Selection(result.best.candidate.strategy,
                            result.best.predicted_step_s,
                            candidate=result.best.candidate,
                            searched=searched)
        except SearchError:
            pass
        for i, strat in enumerate(extras):
            t = step_time(cluster, self.model, strat, self.seq_len,
                          fwd_fraction=frac)
            if sel is None or t < sel.predicted_step_s:
                sel = Selection(strat, t, extra_index=i,
                                searched=searched)
        if sel is None:
            raise RuntimeError("select(): no searched candidate and no "
                               "feasible extras")
        return sel

    def select(self, cluster: ClusterSpec,
               ranks: list[int] | None = None, *,
               extras=()) -> "object":
        """:meth:`select_candidate` without the provenance — just the
        winning cost-model strategy."""
        return self.select_candidate(cluster, ranks, extras=extras).strategy


def search(cluster: ClusterSpec, model: ModelSpec, *,
           global_batch: int, seq_len: int = 4096,
           validate_top: int = 0, executors=("sim",), device=None,
           mesh=None, **searcher_kw) -> SearchResult:
    """One-shot convenience: ``search.driver.search(cluster, model,
    global_batch=..., validate_top=3)``."""
    extra_validate = {}
    for key in ("repeats", "batch", "n_pairs", "d", "f", "max_micro",
                "speed_project", "seed"):
        if key in searcher_kw:
            extra_validate[key] = searcher_kw.pop(key)
    searcher = Searcher(model, global_batch=global_batch,
                        seq_len=seq_len, **searcher_kw)
    return searcher.search(cluster, validate_top=validate_top,
                           executors=executors, device=device, mesh=mesh,
                           **extra_validate)
