"""ANALYTIC pricing of the elastic trace (paper §7.2, Fig 14).

This is the cost-model half of the elastic story — per-config step times
and fused-BSR transition costs on the paper's 32-GPU trace.  The LIVE
half (real ``train_step``s through device loss/join) is
:mod:`repro_torch.elastic.driver`; ``repro_torch.scenarios.elastic`` remains a shim
over this module.

A trace of cluster configurations (C1..C7 with GPU/node failures); on
every transition Hetu:
  1. re-selects a parallel strategy for the surviving devices (cost model
     — the paper's "pre-profiled results combined with a cost model"),
  2. runs *graph specialization* for the new strategy (measured: our real
     resolve/specialize code), and
  3. migrates weights with *fused BSR* (planned on the real planner;
     transfer time estimated on the paper's NVLink/IB topology).

The checkpoint-and-restart baseline (DeepSpeed/Megatron) instead pays a
fixed restart cost and loses in-flight progress; Oobleck-style template
switching is modeled as naive (unfused, min-rank) BSR + broadcast.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.costmodel import (LLAMA_32B, ClusterSpec, ModelSpec,
                                        PipelineSpec, Stage, Strategy,
                                        best_uniform, paper_cluster, step_time)
from repro_torch.core.switching import plan_tensor_switch
from repro_torch.core.topology import NvlinkIbTopology
from repro_torch.scenarios.hetero import strategy_annotations

# the paper's trace (homogeneous: 32 H20)
TRACE_HOMOG = [
    ("C1", list(range(32))),                       # 32 H20
    ("C2", list(range(31))),                       # GPU failure
    ("C3", list(range(24))),                       # node failure
]
# heterogeneous: 16 H800 (ranks 0-15) + 32 H20 (16-47)
TRACE_HETERO = [
    ("C4", list(range(48))),
    ("C5", list(range(40))),                       # node of H20 lost
    ("C6", [r for r in range(40) if r != 15]),     # one H800 lost
    ("C7", list(range(8)) + list(range(16, 40))),  # 8 H800 lost
]


@dataclass
class TransitionReport:
    name: str
    step_time_s: float
    specialize_s: float = 0.0
    switch_plan_s: float = 0.0
    switch_transfer_s: float = 0.0
    total_bytes: int = 0
    messages: int = 0

    @property
    def reconfigure_s(self) -> float:
        return self.specialize_s + self.switch_plan_s + self.switch_transfer_s


def two_pipeline_strategy(ranks: list[int], model: ModelSpec,
                          global_batch: int = 64) -> Strategy:
    """Hetu's fault-isolated two-pipeline layout (Tables 7/8): split the
    rank list into two pipelines with TP4 stages; a remainder that does
    not fill a TP4 stage becomes smaller trailing stages (paper C2's
    2-GPU and 1-GPU stages)."""
    half = (len(ranks) + 1) // 2
    halves = [ranks[:half], ranks[half:]]
    pipelines = []
    for part in halves:
        if not part:
            continue
        stages = []
        groups = []
        i = 0
        while i < len(part):
            take = 4 if len(part) - i >= 4 else len(part) - i
            # avoid 3-GPU stages (odd TP): fold into 2+1
            if take == 3:
                take = 2
            groups.append(tuple(part[i:i + take]))
            i += take
        n_layers = model.n_layers
        # layers proportional to group size (bigger TP -> more layers)
        weights = [len(g) for g in groups]
        tot = sum(weights)
        lo = 0
        for g, w in zip(groups, weights):
            hi = min(n_layers, lo + max(1, round(n_layers * w / tot)))
            if g is groups[-1]:
                hi = n_layers
            stages.append(Stage(g, (lo, hi)))
            lo = hi
        n_micro = max(global_batch // 2, 1)
        pipelines.append(PipelineSpec(tuple(stages), n_micro, 1))
    return Strategy(tuple(pipelines), zero1=False)  # fault isolation


def run_trace(trace, cluster: ClusterSpec, model: ModelSpec = LLAMA_32B,
              global_batch: int = 64, seq_len: int = 4096,
              mode: str = "fused", pricing: str = "analytic",
              searcher=None) -> list[TransitionReport]:
    """Simulate the trace; returns per-config step time + transition cost.

    ``pricing="analytic"`` (the fast default) keeps the 1:2 fwd:bwd
    split; ``pricing="measured"`` prices step times with the fwd share
    of a differentiated ``compile_train`` proxy plan (memoized in
    :mod:`repro_torch.search.rank`).  With a :class:`repro_torch.search.Searcher`
    the per-config strategy is re-SELECTED against the surviving ranks
    (``searcher.select``, restart-free) with the
    hand-written two-pipeline layout competing as an ``extras`` entry;
    otherwise the fixture layout is used directly as before."""
    from repro_torch.core.specialize import resolve_comm_ops  # noqa: F401
    from repro_torch.search.rank import resolve_fwd_fraction
    frac = resolve_fwd_fraction(
        "measured" if pricing == "measured" else None)
    topo = NvlinkIbTopology(
        gpus_per_node=8,
        node_nvlink_gbps={n: (400.0 if cluster.ranks[n * 8].name == "H800"
                              else 900.0)
                          for n in range(len(cluster.ranks) // 8)})
    reports = []
    prev_strat = None
    for name, ranks in trace:
        fixture = two_pipeline_strategy(ranks, model, global_batch)
        if searcher is not None:
            strat = searcher.select(cluster, list(ranks),
                                    extras=(fixture,))
        else:
            strat = fixture
        t_step = step_time(cluster, model, strat, seq_len,
                           fwd_fraction=frac)
        rep = TransitionReport(name, t_step)
        if prev_strat is not None:
            # specialization cost: measured wall time of planning every
            # layer's (src, dst) communication
            t0 = time.perf_counter()
            src_annots = strategy_annotations(prev_strat, model)
            dst_annots = strategy_annotations(strat, model)
            rep.specialize_s = time.perf_counter() - t0
            tensors = []
            for layer in range(model.n_layers):
                shape = (int(model.params_per_layer // model.d_model),
                         model.d_model)
                tensors.append((f"layer{layer}", src_annots[layer],
                                dst_annots[layer], shape, 2))
            sw = plan_tensor_switch(tensors, topo, mode=mode)
            rep.switch_plan_s = sw.planning_seconds
            rep.switch_transfer_s = sw.est_transfer_seconds
            rep.total_bytes = sw.total_bytes
            rep.messages = sw.message_count
        reports.append(rep)
        prev_strat = strat
    return reports


def checkpoint_restart_baseline(trace, cluster: ClusterSpec,
                                model: ModelSpec = LLAMA_32B,
                                global_batch: int = 64,
                                seq_len: int = 4096,
                                restart_s: float = 120.0):
    """DeepSpeed/Megatron: re-tune uniform strategy + full restart.
    A failed GPU discards its whole node (uniform sharding constraint)."""
    reports = []
    for name, ranks in trace:
        # uniform systems must drop incomplete nodes
        by_node: dict[int, list[int]] = {}
        for r in ranks:
            by_node.setdefault(r // 8, []).append(r)
        usable = [r for node, rs in by_node.items() if len(rs) == 8
                  for r in rs]
        strat, t = best_uniform(cluster, model, usable, global_batch,
                                seq_len)
        reports.append(TransitionReport(name, t, specialize_s=restart_s))
    return reports
