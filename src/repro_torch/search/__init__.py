"""Automated HSPMD strategy search: enumerate, prune, rank with the
priced cost model, and validate winners by executing them.

    from repro_torch.search import Searcher, search
    result = search(cluster, model, global_batch=64, validate_top=3)
    result.best.candidate.strategy      # cost-model Strategy
    result.summary()

Pipeline: :mod:`space` (candidate grids over TP x DP x PP x virtual
stages x asymmetric per-group sharding), :mod:`prune` (memory /
divisibility / layer-count feasibility with per-rule rejection counts),
:mod:`rank` (measured-fraction priced pipeline cost model),
:mod:`validate` (top-k executed via ``compile_train`` +
``Session.train_step``, sim↔torch bit-exact),
:mod:`driver` (the restart-free entry point the elastic driver calls).
"""

from .driver import Searcher, SearchResult, search
from .prune import (PruneReport, Rejection, RULES, SearchError,
                    check_candidate, prune)
from .rank import RankedCandidate, proxy_fwd_fraction, rank
from .space import (CPU_A, CPU_B, Candidate, balanced_stages,
                    cpu_cluster, cpu_hetero_cluster,
                    enumerate_candidates, proportional_split, tiny_spec)
from .validate import (ExecutedCandidate, ProxyError, ValidationReport,
                       executable_microbatches, proxy_program, validate)

__all__ = [
    "CPU_A", "CPU_B", "Candidate", "ExecutedCandidate", "ProxyError",
    "PruneReport", "RULES", "RankedCandidate", "Rejection",
    "SearchError", "SearchResult", "Searcher", "ValidationReport",
    "balanced_stages", "check_candidate", "cpu_cluster",
    "cpu_hetero_cluster", "enumerate_candidates",
    "executable_microbatches", "proportional_split", "proxy_program",
    "proxy_fwd_fraction", "prune", "rank", "search", "tiny_spec",
    "validate",
]
