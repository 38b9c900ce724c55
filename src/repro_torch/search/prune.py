"""Feasibility pruning with per-candidate rejection reasons.

Every candidate either survives or is rejected under exactly one of
:data:`RULES`; the :class:`PruneReport` keeps per-rule counts so an
infeasible search raises a debuggable :class:`SearchError` ("12
rejected — divisibility: 9, memory: 3") instead of the old bare
``RuntimeError``.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.costmodel import ClusterSpec, ModelSpec, memory_per_rank

from .space import Candidate

RULES = ("divisibility", "layer-count", "memory")


def check_candidate(cluster: ClusterSpec, model: ModelSpec,
                    cand: Candidate, *,
                    mem_fraction: float = 0.85
                    ) -> tuple[str, str] | None:
    """``(rule, reason)`` when infeasible, ``None`` when the candidate
    survives.  Enumeration-time defects (divisibility, layer-count) are
    carried through; memory is checked here against the cluster."""
    if cand.defect is not None:
        return cand.defect
    strat = cand.strategy
    assert strat is not None
    for p in strat.pipelines:
        for st in p.stages:
            if st.n_layers < cand.v:
                return ("layer-count",
                        f"stage {st.ranks} holds {st.n_layers} layers "
                        f"< {cand.v} virtual stages")
    worst_r, worst_frac = -1, 0.0
    for r, gb in memory_per_rank(model, strat).items():
        frac = gb / cluster.ranks[r].mem_gb
        if frac > worst_frac:
            worst_r, worst_frac = r, frac
    if worst_frac > mem_fraction:
        return ("memory",
                f"rank {worst_r} needs {worst_frac:.2f}x of its "
                f"{cluster.ranks[worst_r].mem_gb:.0f} GB "
                f"(limit {mem_fraction:.2f}x)")
    return None


@dataclass(frozen=True)
class Rejection:
    candidate: Candidate
    rule: str
    reason: str


@dataclass(frozen=True)
class PruneReport:
    n_candidates: int
    survivors: tuple[Candidate, ...]
    rejections: tuple[Rejection, ...]

    def counts(self) -> dict[str, int]:
        out = {rule: 0 for rule in RULES}
        for rej in self.rejections:
            out[rej.rule] = out.get(rej.rule, 0) + 1
        return out

    def summary(self) -> str:
        counts = self.counts()
        per_rule = ", ".join(f"{rule}: {counts[rule]}" for rule in RULES
                             if counts.get(rule))
        return (f"{self.n_candidates} candidates -> "
                f"{len(self.survivors)} feasible, "
                f"{len(self.rejections)} rejected"
                + (f" ({per_rule})" if per_rule else ""))


class SearchError(RuntimeError):
    """No feasible strategy; ``.report`` holds the full prune trail."""

    def __init__(self, report: PruneReport,
                 what: str = "strategy") -> None:
        self.report = report
        counts = report.counts()
        per_rule = ", ".join(f"{rule}: {counts[rule]}" for rule in RULES)
        super().__init__(
            f"no feasible {what} found: {len(report.rejections)} "
            f"candidates rejected ({per_rule})")


def prune(cluster: ClusterSpec, model: ModelSpec,
          candidates: list[Candidate], *,
          mem_fraction: float = 0.85) -> PruneReport:
    survivors: list[Candidate] = []
    rejections: list[Rejection] = []
    for cand in candidates:
        verdict = check_candidate(cluster, model, cand,
                                  mem_fraction=mem_fraction)
        if verdict is None:
            survivors.append(cand)
        else:
            rejections.append(Rejection(cand, *verdict))
    return PruneReport(len(candidates), tuple(survivors),
                       tuple(rejections))
