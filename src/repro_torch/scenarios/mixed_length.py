"""Mixed-length data scenario (paper §7.3, Figs 15-16).

Per training step a fresh sample of variable-length sequences
(~200K tokens) is processed under one of four policies:

  * ``baseline``  — DeepSpeed/Megatron: pack everything into the full
    context window under a fixed long-sequence-friendly strategy;
  * ``hotspa`` (== Hetu-A) — bucket by length, switch between
    *homogeneous* strategies within the step (gradient accumulation
    across buckets), paying intra-step switch overhead per bucket pair;
  * ``hetu_b``    — pick one of two *heterogeneous* strategies per step
    from the batch's max sequence length; long sequences go to the
    high-TP pipeline and short ones to the small pipelines, balanced by
    a cost model; strategy switches happen only when consecutive steps
    change regime (Fig 16).

Step times come from the calibrated cluster cost model; switch costs from
the real fused-BSR planner (as in the elastic scenario).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core.costmodel import (LLAMA_32B, ClusterSpec, ModelSpec,
                                        PipelineSpec, Stage, Strategy,
                                        paper_cluster, step_time)
from repro_torch.core.switching import plan_tensor_switch
from repro_torch.core.topology import NvlinkIbTopology
from repro_torch.data.pipeline import (Bucket, CorpusConfig, SyntheticCorpus,
                                       bucketize, step_stream)
from repro_torch.scenarios.hetero import layer_weight_shapes, strategy_annotations

H20_RANKS = list(range(32))


def _uniform(ranks, model, dp, tp, pp, micro, n_micro):
    from repro_torch.core.costmodel import uniform_strategy
    return uniform_strategy(list(ranks), model, dp=dp, tp=tp, pp=pp,
                            global_batch=dp * n_micro * micro,
                            micro_bs=micro)


# Table 10: interval strategies for HotSPa / Hetu-A (32 H20, 32K context)
def bucket_strategies_32k(model: ModelSpec):
    return {
        Bucket(16384, 32768): _uniform(H20_RANKS, model, 2, 16, 1, 1, 4),
        Bucket(4096, 16384): _uniform(H20_RANKS, model, 2, 8, 2, 1, 8),
        Bucket(0, 4096): _uniform(H20_RANKS, model, 4, 4, 2, 1, 8),
    }


# Table 11: Hetu-B heterogeneous strategies (32 H20)
def hetu_b_strategy_long(model: ModelSpec) -> Strategy:
    """Strategy 1 (16K < max <= 32K): one TP16 long pipeline + four TP4
    short pipelines."""
    pipes = [PipelineSpec((Stage(tuple(range(0, 16)), (0, model.n_layers)),),
                          4, 1)]
    for g in range(4):
        ranks = tuple(range(16 + g * 4, 20 + g * 4))
        pipes.append(PipelineSpec((Stage(ranks, (0, model.n_layers)),), 8, 1))
    return Strategy(tuple(pipes))


def hetu_b_strategy_short(model: ModelSpec) -> Strategy:
    """Strategy 2 (max <= 16K): one TP8 long pipeline + three 2-stage
    TP4 short pipelines."""
    pipes = [PipelineSpec((Stage(tuple(range(0, 8)), (0, model.n_layers)),),
                          4, 1)]
    half = model.n_layers // 2
    for g in range(3):
        a = 8 + g * 8
        pipes.append(PipelineSpec(
            (Stage(tuple(range(a, a + 4)), (0, half)),
             Stage(tuple(range(a + 4, a + 8)), (half, model.n_layers))),
            8, 1))
    return Strategy(tuple(pipes))


@dataclass
class StepReport:
    step: int
    policy: str
    seconds: float
    max_len: int
    n_seqs: int
    switched: bool = False
    switch_s: float = 0.0


# -- sequence-exact cost accounting ------------------------------------------
#
# The physics the paper exploits: attention is quadratic in the *actual*
# attended length.  Packing short documents into a 32K window under a
# fixed long-context strategy pays 32K^2 attention per window and drags
# every token through a high-TP group; per-sequence processing pays
# sum(len^2) and lets short sequences ride cheap low-TP pipelines.

def _seq_flops(model: ModelSpec, length: int) -> float:
    """fwd+bwd FLOPs for ONE sequence at its own attended length."""
    dense = 6 * model.params_per_layer * length * model.n_layers
    attn = 12 * model.d_model * length * length * model.n_layers
    head = 6 * model.d_model * model.vocab * length
    return dense + attn + head


def _pipeline_rate(cluster: ClusterSpec, p: PipelineSpec,
                   ref_len: int, model: ModelSpec) -> float:
    """Effective FLOPs/s of one pipeline, scored by the PRICED timetable
    it would execute (``costmodel.pipeline_time`` re-times the 1F1B tick
    table under per-(stage, phase) durations), so heterogeneous stage
    splits pay their own fill ramp instead of the uniform
    ``(m + S - 1)/m`` bottleneck factor."""
    from repro_torch.core.costmodel import pipeline_time
    if p.n_micro < 1 or p.micro_bs < 1:     # degenerate specs: clamp
        p = dataclasses.replace(p, n_micro=max(p.n_micro, 1),
                                micro_bs=max(p.micro_bs, 1))
    micro_tokens = p.micro_bs * ref_len
    per_micro = sum(model.layer_flops(micro_tokens, ref_len) * st.n_layers
                    for st in p.stages)
    t_step = pipeline_time(cluster, model, p, ref_len)
    return per_micro * p.n_micro / t_step


def _strategy_step_time(cluster, model, strat, seqs, context, *,
                        packed_window: int | None = None) -> float:
    """Sequence-exact processing time under a strategy.

    ``packed_window``: baseline semantics — sequences are packed into
    fixed windows of that size and attention is paid at window length.
    Otherwise sequences keep their own lengths and are dispatched to the
    pipeline with the earliest finish time (the paper's cost-model
    dispatch), longest first.
    """
    if packed_window:
        total = sum(min(len(s), packed_window) for s in seqs)
        n_windows = max(1, -(-total // packed_window))
        work = [_seq_flops(model, packed_window)] * n_windows
        ref = packed_window
    else:
        work = sorted((_seq_flops(model, len(s)) for s in seqs),
                      reverse=True)
        ref = max(len(s) for s in seqs)
    rates = [_pipeline_rate(cluster, p, min(ref, context), model)
             for p in strat.pipelines]
    finish = [0.0] * len(rates)
    for w in work:  # greedy earliest-finish dispatch
        i = min(range(len(rates)), key=lambda j: finish[j] + w / rates[j])
        finish[i] += w / rates[i]
    from repro_torch.core.costmodel import dp_sync_time
    return max(finish) + dp_sync_time(cluster, model, strat)


def _switch_cost(model, src: Strategy, dst: Strategy, topo) -> float:
    shapes = layer_weight_shapes(model)
    sa = strategy_annotations(src, model)
    da = strategy_annotations(dst, model)
    tensors = [(name, sa[layer], da[layer], shapes[name], 2)
               for layer, name in enumerate(shapes)]
    return plan_tensor_switch(tensors, topo).est_transfer_seconds


def run_mixed_length(policy: str, *, context: int = 32768,
                     corpus_name: str = "commoncrawl", n_steps: int = 30,
                     tokens_per_step: int = 200_000,
                     model: ModelSpec = LLAMA_32B,
                     seed: int = 0) -> list[StepReport]:
    cluster = ClusterSpec(tuple(
        dataclasses.replace(paper_cluster(0, 32).ranks[0])
        for _ in range(32)))
    topo = NvlinkIbTopology(gpus_per_node=8, nvlink_gbps=900.0)
    corpus = SyntheticCorpus(CorpusConfig(corpus_name, seed=seed,
                                          max_len=context))
    buckets = bucket_strategies_32k(model)
    s_long = hetu_b_strategy_long(model)
    s_short = hetu_b_strategy_short(model)
    baseline = _uniform(H20_RANKS, model, 2, 16, 1, 1, 4)

    reports = []
    cur_b = None
    for step, seqs in enumerate(step_stream(corpus, tokens_per_step,
                                            n_steps)):
        max_len = max(len(s) for s in seqs)
        if policy == "baseline":
            t = _strategy_step_time(cluster, model, baseline, seqs, context,
                                    packed_window=context)
            reports.append(StepReport(step, policy, t, max_len, len(seqs)))
        elif policy in ("hotspa", "hetu_a"):
            # per-bucket sub-steps + intra-step strategy switches
            by_bucket = bucketize(seqs, tuple(buckets))
            t_total, switches = 0.0, 0
            prev = None
            for b, strat in buckets.items():
                sub = by_bucket.get(b, [])
                if not sub:
                    continue
                t_total += _strategy_step_time(
                    cluster, model, strat, sub, min(b.hi, context),
                    packed_window=min(b.hi, context))
                if prev is not None:
                    t_total += _switch_cost(model, prev, strat, topo)
                    switches += 1
                prev = strat
            reports.append(StepReport(step, policy, t_total, max_len,
                                      len(seqs), switched=switches > 0))
        elif policy == "hetu_b":
            want = s_long if max_len > 16384 else s_short
            t = _strategy_step_time(cluster, model, want, seqs, context)
            sw, t_sw = False, 0.0
            if cur_b is not None and want is not cur_b:
                t_sw = _switch_cost(model, cur_b, want, topo)
                t += t_sw
                sw = True
            cur_b = want
            reports.append(StepReport(step, policy, t, max_len, len(seqs),
                                      switched=sw, switch_s=t_sw))
        else:
            raise ValueError(policy)
    return reports
