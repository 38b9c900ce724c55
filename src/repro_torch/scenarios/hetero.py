"""Heterogeneous-cluster strategies (paper §7.1, Appendix A.2 Table 5).

The paper's optimal Hetu strategies are encoded verbatim as
:class:`Strategy` fixtures; the DeepSpeed/Megatron baselines come from
``best_uniform`` (their own tuners).  ``strategy_annotations`` expresses a
strategy's per-layer weight placement as HSPMD annotations — the bridge
that lets graph switching (fused BSR) and communication resolution operate
on cost-model strategies.
"""

from __future__ import annotations

from repro_torch.core.annotations import DG, DS, DUP, HSPMD, PARTIAL
from repro_torch.core.costmodel import (LLAMA_32B, LLAMA_70B, ClusterSpec,
                                        ModelSpec, PipelineSpec, Stage, Strategy,
                                        paper_cluster)

# rank convention (paper Appendix A): R0-15 = H800, R16-47 = H20


def _stages(*spec):
    """spec: (ranks, lo, hi) triples."""
    return tuple(Stage(tuple(ranks), (lo, hi)) for ranks, lo, hi in spec)


def hetu_32b_16h800_16h20() -> Strategy:
    """Table 5 row 1: two 4.5-stage pipelines, H20 stages carry fewer
    layers; 32 x bs1 microbatches each."""
    p1 = PipelineSpec(_stages(
        (range(16, 20), 0, 7), (range(20, 24), 7, 14),
        (range(0, 4), 14, 37), (range(4, 8), 37, 60)), 32, 1)
    p2 = PipelineSpec(_stages(
        (range(24, 28), 0, 7), (range(28, 32), 7, 14),
        (range(8, 12), 14, 37), (range(12, 16), 37, 60)), 32, 1)
    return Strategy((p1, p2))


def hetu_32b_16h800_32h20() -> Strategy:
    """Table 5 row 3: four 3-stage pipelines (DP=4)."""
    pipes = []
    h20_groups = [(16, 20, 20, 24), (24, 28, 28, 32),
                  (32, 36, 36, 40), (40, 44, 44, 48)]
    h800_groups = [(0, 4), (4, 8), (8, 12), (12, 16)]
    for (a, b, c, d), (e, f) in zip(h20_groups, h800_groups):
        pipes.append(PipelineSpec(_stages(
            (range(a, b), 0, 11), (range(c, d), 11, 22),
            (range(e, f), 22, 60)), 16, 1))
    return Strategy(tuple(pipes))


def hetu_70b_16h800_16h20() -> Strategy:
    """Table 5: 70B single pipeline, TP8 stages."""
    p = PipelineSpec(_stages(
        (range(16, 24), 0, 11), (range(24, 32), 11, 22),
        (range(0, 8), 22, 51), (range(8, 16), 51, 80)), 64, 1)
    return Strategy((p,))


HETU_STRATEGIES = {
    ("llama-32b", 16, 16): hetu_32b_16h800_16h20,
    ("llama-32b", 16, 32): hetu_32b_16h800_32h20,
    ("llama-70b", 16, 16): hetu_70b_16h800_16h20,
}


def priced_schedule_stats(cluster: ClusterSpec, model: ModelSpec,
                          strat: Strategy, seq_len: int,
                          fwd_fraction: float | str | None = None):
    """Per-pipeline :class:`~repro_torch.core.schedule.ScheduleStats` of the
    timetables this strategy would execute, with tick durations priced
    from the cost model per (stage, phase) — the paper's temporal
    heterogeneity (§5, §7) made visible: the H20 stages' shorter layer
    ranges yield shorter ticks, and the *priced* makespan / bubble
    fraction reflect the actual (non-uniform) fill/drain shape rather
    than bottleneck-uniform slot counts.

    ``fwd_fraction`` controls the fwd:bwd tick split: ``None`` (the
    fast default) keeps the analytic 1:2 ratio; ``"measured"`` prices
    with the fwd share of a differentiated ``compile_train`` proxy plan
    (:func:`repro_torch.search.rank.proxy_fwd_fraction`, memoized); a float
    passes through."""
    from repro_torch.core.costmodel import pipeline_tick_durations
    from repro_torch.core.schedule import build_schedule
    from repro_torch.search.rank import resolve_fwd_fraction

    frac = resolve_fwd_fraction(fwd_fraction)
    out = []
    for p in strat.pipelines:
        sched = build_schedule(len(p.stages), p.n_micro, strat.schedule)
        out.append(sched.stats(pipeline_tick_durations(
            cluster, model, p, seq_len, fwd_fraction=frac)))
    return out


# ---------------------------------------------------------------------------
# strategy -> HSPMD annotations (per-layer weight placement)
# ---------------------------------------------------------------------------

def strategy_annotations(strat: Strategy, model: ModelSpec,
                         shard_dim: int = 0) -> dict[int, HSPMD]:
    """For each layer: the HSPMD annotation of its (flattened) weight.

    Each pipeline that owns the layer contributes one sharding subgroup
    (its TP group, Split along ``shard_dim``); pipelines are united under
    ``hdim = DUP`` (data-parallel replicas of the layer's weights) — the
    exact Fig 12 structure that graph switching reshards.
    """
    out: dict[int, HSPMD] = {}
    for layer in range(model.n_layers):
        dgs, dss = [], []
        for p in strat.pipelines:
            for st in p.stages:
                if st.layers[0] <= layer < st.layers[1]:
                    dgs.append(DG(st.ranks))
                    dss.append(DS({shard_dim: st.tp}) if st.tp > 1
                               else DS({}))
        if not dgs:
            raise ValueError(f"layer {layer} unassigned")
        out[layer] = HSPMD(dgs, dss, hdim=DUP)
    return out


def to_api_strategy(name: str, strat: Strategy, model: ModelSpec,
                    shard_dim: int = 0, topology=None):
    """Export a cost-model Strategy as a ``repro_torch.api.Strategy`` over the
    per-layer weight view (``layer{i}`` tensors) — the bridge that lets
    ``api.Program`` / ``api.Session`` compile and switch the paper's
    Table 5 strategies."""
    from repro_torch.api import Strategy as ApiStrategy
    annots = {f"layer{i}": a for i, a in
              strategy_annotations(strat, model, shard_dim).items()}
    return ApiStrategy(name, annots, topology)


def layer_weight_shapes(model: ModelSpec) -> dict[str, tuple[int, int]]:
    """Flattened per-layer weight shapes matching ``to_api_strategy``."""
    shape = (int(model.params_per_layer // model.d_model),
             int(model.d_model))
    return {f"layer{i}": shape for i in range(model.n_layers)}


def grad_sync_annotations(strat: Strategy, model: ModelSpec) \
        -> dict[int, tuple[HSPMD, HSPMD]]:
    """(src, dst) annotation pairs for per-layer gradient sync: Partial
    across DP subgroups -> Duplicate (SplitAR when TP degrees differ —
    the paper's Fig 17 pattern)."""
    out = {}
    for layer, annot in strategy_annotations(strat, model).items():
        if annot.hsize <= 1:
            continue
        src = HSPMD(annot.dgs, annot.dss, hdim=PARTIAL)
        dst = HSPMD(annot.dgs, annot.dss, hdim=DUP)
        out[layer] = (src, dst)
    return out
