"""Strategy-space enumeration (the search subsystem's candidate grid).

The paper selects hetero strategies from "pre-profiled results combined
with a cost model" (§7.2); HAP (PAPERS.md) shows the strategy program
itself can be synthesized.  This module enumerates the candidate space a
``ClusterSpec`` + ``ModelSpec`` admits:

* **uniform** candidates — TP x DP x PP x virtual-stage x micro-batch
  grids over the rank list (the DeepSpeed/Megatron axes), and
* **hetero** candidates — per-device-type TP degrees with layer counts
  assigned proportionally to stage compute power (the paper's Table 5
  shape: asymmetric per-group sharding, slower device classes feeding
  the early stages with fewer layers).

Every grid point becomes a :class:`Candidate` — including infeasible
ones, which carry a ``defect`` (rule, reason) instead of a cost-model
``Strategy`` so the pruner can report per-rule rejection counts instead
of silently skipping.  Enumeration order is DETERMINISTIC (sorted
grids), which the driver's memoization and the tests rely on.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.core.costmodel import (ClusterSpec, DeviceType,
                                        ModelSpec, PipelineSpec, Stage,
                                        Strategy)

# -- CPU fixtures for execution validation ----------------------------------
# The validator executes candidates on forced CPU meshes; these device
# classes keep the cost model's compute term dominant (tiny tflops) and
# the comm terms small (one fat intra-node link).  ``cpuB`` is a second
# CLASS (its own name -> the hetero enumeration applies) at half speed
# and smaller memory.
CPU_A = DeviceType("cpuA", 2e-4, 64.0, 64.0)
CPU_B = DeviceType("cpuB", 1e-4, 48.0, 64.0)


def cpu_cluster(n: int) -> ClusterSpec:
    """Homogeneous n-rank CPU fixture."""
    return ClusterSpec((CPU_A,) * n)


def cpu_hetero_cluster(n_fast: int, n_slow: int,
                       slow_tflops: float | None = None) -> ClusterSpec:
    """Two-class CPU fixture: ``n_fast`` cpuA ranks then ``n_slow``
    cpuB ranks (half speed by default; pass ``slow_tflops`` to change
    the ratio — e.g. ``CPU_A.tflops`` for classes that differ only in
    memory, which execution validation on an equal-speed CPU mesh can
    rank without speed projection)."""
    slow = CPU_B if slow_tflops is None else DeviceType(
        "cpuB", slow_tflops, CPU_B.mem_gb, CPU_B.nvlink_gbps)
    return ClusterSpec((CPU_A,) * n_fast + (slow,) * n_slow)


def tiny_spec(n_layers: int = 8) -> ModelSpec:
    """A model small enough that CPU-fixture searches stay feasible."""
    return ModelSpec("cpu-tiny", n_layers, 64, 256, vocab=512)


# -- proportional layer assignment ------------------------------------------

def proportional_split(weights: list[float], total: int) -> list[int]:
    """``len(weights)`` counts, each >= 1, summing to ``total``,
    proportional to ``weights``.  Allocates against the REMAINING budget
    so no stage can be starved to zero (the bug the old
    ``scenarios.search._balanced_stages`` had when the group count
    approached the layer count)."""
    n = len(weights)
    if n > total:
        raise ValueError(f"cannot split {total} layers into {n} "
                         f"groups of >= 1 layer each")
    out: list[int] = []
    rem_w = float(sum(weights))
    rem_t = total
    for i, w in enumerate(weights):
        trailing = n - i - 1
        if trailing == 0:
            c = rem_t
        else:
            want = round(rem_t * w / rem_w) if rem_w > 0 else 1
            # leave >= 1 for every remaining group
            c = max(1, min(want, rem_t - trailing))
        out.append(c)
        rem_t -= c
        rem_w -= w
    return out


def balanced_stages(groups: list[tuple[tuple[int, ...], float]],
                    n_layers: int) -> list[Stage]:
    """Assign layer ranges to TP groups proportionally to throughput;
    every stage gets at least one layer (raises ``ValueError`` when
    there are more groups than layers)."""
    counts = proportional_split([p for _, p in groups], n_layers)
    stages, lo = [], 0
    for (ranks, _), c in zip(groups, counts):
        stages.append(Stage(tuple(ranks), (lo, lo + c)))
        lo += c
    return stages


# -- candidates --------------------------------------------------------------

@dataclass(frozen=True)
class Candidate:
    """One point of the search space.

    ``strategy`` is the cost-model :class:`Strategy` (None when the grid
    point cannot even be built — then ``defect`` names the pruning rule
    and reason).  ``dp`` counts pipelines (DP replicas for uniform
    candidates, hetero subgroups for hetero ones), ``pp`` physical
    stages per pipeline, ``v`` Megatron virtual stages per device,
    ``group_tps`` the per-device-type TP degrees of hetero candidates.
    """

    name: str
    kind: str                       # "uniform" | "hetero"
    dp: int
    tp: int                         # 0 for hetero (see group_tps)
    pp: int
    v: int
    micro_bs: int
    n_micro: int
    schedule: str                   # "1f1b" | "interleaved"
    strategy: Strategy | None
    group_tps: tuple[tuple[str, int], ...] = ()
    defect: tuple[str, str] | None = None

    @property
    def n_devices(self) -> int:
        return self.strategy.device_count() if self.strategy else 0

    def describe(self) -> str:
        if self.defect:
            return f"{self.name}: REJECTED[{self.defect[0]}] {self.defect[1]}"
        extra = "".join(f" {t}:tp{k}" for t, k in self.group_tps)
        return (f"{self.name}: {self.kind} dp{self.dp} pp{self.pp} "
                f"v{self.v} m{self.n_micro}x{self.micro_bs}{extra}")


def _defect(name: str, kind: str, rule: str, reason: str,
            **dims) -> Candidate:
    base = dict(dp=0, tp=0, pp=0, v=1, micro_bs=1, n_micro=0,
                schedule="1f1b")
    base.update(dims)
    return Candidate(name=name, kind=kind, strategy=None,
                     defect=(rule, reason), **base)


def _uniform_candidate(ranks: list[int], model: ModelSpec, tp: int, pp: int,
                       v: int, mbs: int, global_batch: int) -> Candidate:
    n = len(ranks)
    sched = "interleaved" if v > 1 else "1f1b"
    vtag = f".v{v}" if v > 1 else ""
    mtag = f".mbs{mbs}" if mbs > 1 else ""
    if n % (tp * pp):
        return _defect(f"tp{tp}.pp{pp}{vtag}{mtag}", "uniform",
                       "divisibility",
                       f"tp*pp={tp * pp} does not divide {n} ranks",
                       tp=tp, pp=pp, v=v, micro_bs=mbs, schedule=sched)
    dp = n // (tp * pp)
    name = f"dp{dp}.tp{tp}.pp{pp}{vtag}{mtag}"
    if global_batch % (dp * mbs):
        return _defect(name, "uniform", "divisibility",
                       f"global batch {global_batch} not divisible by "
                       f"dp*micro_bs={dp * mbs}",
                       dp=dp, tp=tp, pp=pp, v=v, micro_bs=mbs,
                       schedule=sched)
    n_micro = global_batch // (dp * mbs)
    if pp * v > model.n_layers:
        return _defect(name, "uniform", "layer-count",
                       f"{pp}x{v} virtual stages exceed "
                       f"{model.n_layers} layers",
                       dp=dp, tp=tp, pp=pp, v=v, micro_bs=mbs,
                       n_micro=n_micro, schedule=sched)
    if v > 1 and n_micro % pp and n_micro > pp:
        return _defect(name, "uniform", "divisibility",
                       f"interleaved needs m % pp == 0 or m <= pp "
                       f"(m={n_micro}, pp={pp})",
                       dp=dp, tp=tp, pp=pp, v=v, micro_bs=mbs,
                       n_micro=n_micro, schedule=sched)
    counts = proportional_split([1.0] * pp, model.n_layers)
    pipelines, idx = [], 0
    for _ in range(dp):
        stages, lo = [], 0
        for s in range(pp):
            grp = tuple(ranks[idx:idx + tp])
            idx += tp
            stages.append(Stage(grp, (lo, lo + counts[s])))
            lo += counts[s]
        pipelines.append(PipelineSpec(tuple(stages), n_micro, mbs))
    strat = Strategy(tuple(pipelines))
    return Candidate(name=name, kind="uniform", dp=dp, tp=tp, pp=pp, v=v,
                     micro_bs=mbs, n_micro=n_micro, schedule=sched,
                     strategy=strat)


def _hetero_candidates(cluster: ClusterSpec, model: ModelSpec,
                       ranks: list[int], global_batch: int,
                       pipeline_options, tp_options,
                       micro_bs_options) -> list[Candidate]:
    by_type: dict[str, list[int]] = {}
    for r in ranks:
        by_type.setdefault(cluster.ranks[r].name, []).append(r)
    types = sorted(by_type)
    out: list[Candidate] = []
    for n_pipes in sorted(pipeline_options):
        if any(len(v) % n_pipes for v in by_type.values()):
            out.append(_defect(
                f"het{n_pipes}", "hetero", "divisibility",
                f"{n_pipes} pipelines do not divide the per-type rank "
                f"counts {[len(by_type[t]) for t in types]}",
                dp=n_pipes))
            continue
        per_pipe = {t: [v[i::n_pipes] for i in range(n_pipes)]
                    for t, v in by_type.items()}
        for tps in itertools.product(sorted(tp_options),
                                     repeat=len(types)):
            tag = "het{}x".format(n_pipes) + "-".join(
                f"{t}.tp{k}" for t, k in zip(types, tps))
            group_tps = tuple(zip(types, tps))
            bad = next((t for t, k in zip(types, tps)
                        if len(per_pipe[t][0]) % k), None)
            if bad is not None:
                out.append(_defect(
                    tag, "hetero", "divisibility",
                    f"tp={dict(group_tps)[bad]} does not divide the "
                    f"{len(per_pipe[bad][0])} {bad} ranks per pipeline",
                    dp=n_pipes, group_tps=group_tps))
                continue
            pipes, n_groups = [], 0
            for pi in range(n_pipes):
                groups = []
                for t, tp in zip(types, tps):
                    chunk = per_pipe[t][pi]
                    power = cluster.ranks[chunk[0]].tflops * tp
                    for gidx in range(len(chunk) // tp):
                        groups.append(
                            (tuple(chunk[gidx * tp:(gidx + 1) * tp]),
                             power))
                # slower device classes feed the early stages (paper
                # Table 5 places the H20 stages first); rank id breaks
                # power ties deterministically
                groups.sort(key=lambda g: (g[1], g[0]))
                n_groups = len(groups)
                if n_groups > model.n_layers:
                    break
                stages = balanced_stages(groups, model.n_layers)
                pipes.append(stages)
            if n_groups > model.n_layers:
                out.append(_defect(
                    tag, "hetero", "layer-count",
                    f"{n_groups} stages per pipeline exceed "
                    f"{model.n_layers} layers",
                    dp=n_pipes, pp=n_groups, group_tps=group_tps))
                continue
            for mbs in sorted(micro_bs_options):
                mtag = f".mbs{mbs}" if mbs > 1 else ""
                if global_batch % (n_pipes * mbs):
                    out.append(_defect(
                        tag + mtag, "hetero", "divisibility",
                        f"global batch {global_batch} not divisible by "
                        f"pipelines*micro_bs={n_pipes * mbs}",
                        dp=n_pipes, pp=n_groups, micro_bs=mbs,
                        group_tps=group_tps))
                    continue
                n_micro = global_batch // (n_pipes * mbs)
                strat = Strategy(tuple(
                    PipelineSpec(tuple(stages), n_micro, mbs)
                    for stages in pipes))
                out.append(Candidate(
                    name=tag + mtag, kind="hetero", dp=n_pipes, tp=0,
                    pp=n_groups, v=1, micro_bs=mbs, n_micro=n_micro,
                    schedule="1f1b", strategy=strat,
                    group_tps=group_tps))
    return out


def enumerate_candidates(cluster: ClusterSpec, model: ModelSpec,
                         ranks: list[int] | None = None, *,
                         global_batch: int,
                         tp_options=(1, 2, 4, 8),
                         pp_options=(1, 2, 4, 8),
                         virtual_options=(1, 2),
                         micro_bs_options=(1,),
                         pipeline_options=(1, 2, 4),
                         include_uniform: bool = True,
                         include_hetero: bool = True) -> list[Candidate]:
    """The full candidate list (deterministic order; includes defect
    candidates so pruning can count per-rule rejections).

    Uniform candidates sweep TP x PP x v x micro-bs grids (DP is
    implied by the rank count); hetero candidates sweep pipeline counts
    x per-device-type TP degrees with power-proportional layer ranges.
    Interleaved (v > 1) sweeps are uniform-only — hetero candidates
    already break symmetry through their stage shapes.
    """
    ranks = sorted(ranks if ranks is not None else
                   range(len(cluster.ranks)))
    if not ranks:
        raise ValueError("enumerate_candidates needs at least one rank")
    out: list[Candidate] = []
    if include_uniform:
        for tp in sorted(tp_options):
            for pp in sorted(pp_options):
                for v in sorted(virtual_options):
                    if v > 1 and pp == 1:
                        continue    # interleaving needs a real pipeline
                    for mbs in sorted(micro_bs_options):
                        out.append(_uniform_candidate(
                            ranks, model, tp, pp, v, mbs, global_batch))
    if include_hetero:
        out.extend(_hetero_candidates(
            cluster, model, ranks, global_batch, pipeline_options,
            tp_options, micro_bs_options))
    return out
