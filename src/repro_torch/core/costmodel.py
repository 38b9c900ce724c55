"""Analytical cluster cost model (drives the Fig 13/14/15 reproductions).

The container is CPU-only, so the paper's wall-clock cluster numbers are
reproduced with a calibrated analytical model over the paper's own
hardware table (Appendix A.1):

  H800: 990 TFLOPS bf16, 80 GB, 400 GB/s NVLink
  H20:  148 TFLOPS bf16, 96 GB, 900 GB/s NVLink
  inter-node: IB (25 GB/s per GPU)

A *strategy* is a set of pipelines; each pipeline is a list of stages;
each stage owns a device group (TP applied inside), a layer range and a
micro-batch schedule.  This mirrors the paper's Appendix A.2/A.3 strategy
tables, which are encoded verbatim as fixtures in the benchmarks.

Per-step time =
  the PRICED pipeline timetable (1F1B or GPipe; the executable tick
    table from ``core.schedule`` re-timed under per-(stage, phase)
    durations — ``stage_tick_times`` — so non-uniform stage splits are
    scored by the schedule they'd run; uniform stages keep the
    ``fill_drain_count`` closed form, asserted equal)
  + cross-pipeline gradient sync (heterogeneous DP -> SplitAR over the
    HSPMD annotations, costed per link)
and per-stage microbatch time =
  max over stage devices of (stage FLOPs / (TP x device FLOPS x MFU))
  + TP collective time (2 AR of activation bytes per layer over the
    group's NVLink) + P2P stage-boundary transfer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class DeviceType:
    name: str
    tflops: float          # bf16 peak
    mem_gb: float
    nvlink_gbps: float


H800 = DeviceType("H800", 990.0, 80.0, 400.0)
H20 = DeviceType("H20", 148.0, 96.0, 900.0)
IB_GBPS = 25.0
MFU = 0.45                  # calibrated utilization factor


@dataclass(frozen=True)
class ClusterSpec:
    """rank -> device type; node = 8 consecutive ranks."""

    ranks: tuple[DeviceType, ...]

    def node_of(self, r: int) -> int:
        return r // 8

    def link_gbps(self, a: int, b: int) -> float:
        if self.node_of(a) == self.node_of(b):
            return min(self.ranks[a].nvlink_gbps, self.ranks[b].nvlink_gbps)
        return IB_GBPS


def paper_cluster(n_h800: int = 16, n_h20: int = 32) -> ClusterSpec:
    return ClusterSpec(tuple([H800] * n_h800 + [H20] * n_h20))


@dataclass(frozen=True)
class ModelSpec:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int = 32000

    @property
    def params_per_layer(self) -> float:
        return 4 * self.d_model ** 2 + 3 * self.d_model * self.d_ff

    @property
    def total_params(self) -> float:
        return (self.n_layers * self.params_per_layer
                + 2 * self.vocab * self.d_model)

    def layer_flops(self, tokens: int, seq_len: int) -> float:
        """fwd+bwd FLOPs for one layer over `tokens` tokens."""
        dense = 6 * self.params_per_layer * tokens
        attn = 12 * self.d_model * tokens * seq_len  # score+value matmuls
        return dense + attn

    @classmethod
    def from_config(cls, cfg) -> "ModelSpec":
        """Bridge a ``models.config.ModelConfig`` (the named ``configs/``
        pool — what ``Graph.transformer_block`` builds from) into the
        analytic cost model, so compiled graph-IR strategies and the
        Appendix A strategy tables price the same architectures."""
        return cls(cfg.name, cfg.n_layers, cfg.d_model, cfg.d_ff,
                   vocab=cfg.vocab)


LLAMA_32B = ModelSpec("llama-32b", 60, 6656, 17920)
LLAMA_70B = ModelSpec("llama-70b", 80, 8192, 28672)


@dataclass(frozen=True)
class Stage:
    ranks: tuple[int, ...]       # TP group (all compute every layer)
    layers: tuple[int, int]      # [lo, hi) layer ids

    @property
    def tp(self) -> int:
        return len(self.ranks)

    @property
    def n_layers(self) -> int:
        return self.layers[1] - self.layers[0]


@dataclass(frozen=True)
class PipelineSpec:
    stages: tuple[Stage, ...]
    n_micro: int
    micro_bs: int               # sequences per microbatch


@dataclass(frozen=True)
class Strategy:
    pipelines: tuple[PipelineSpec, ...]
    schedule: str = "1f1b"      # or "gpipe"
    zero1: bool = True

    def device_count(self) -> int:
        return sum(len(s.ranks) for p in self.pipelines for s in p.stages)


def stage_micro_time(cluster: ClusterSpec, model: ModelSpec, st: Stage,
                     micro_tokens: int, seq_len: int) -> float:
    """Seconds for one microbatch fwd+bwd through one stage."""
    flops = model.layer_flops(micro_tokens, seq_len) * st.n_layers
    slowest = min(cluster.ranks[r].tflops for r in st.ranks)
    t_comp = flops / (st.tp * slowest * 1e12 * MFU)
    if st.tp > 1:
        # Megatron TP: 4 collectives (fwd+bwd) of activation size per layer
        act_bytes = 2 * micro_tokens * model.d_model
        link = min(cluster.link_gbps(st.ranks[0], r) for r in st.ranks[1:])
        t_tp = st.n_layers * 4 * act_bytes * (st.tp - 1) / st.tp \
            / (link * 1e9)
    else:
        t_tp = 0.0
    return t_comp + t_tp


def fill_drain_count(n_micro: int, n_stages: int) -> int:
    """The 1F1B/GPipe fill+steady+drain slot count ``(m + s - 1)`` —
    the same shape the schedule engine's timetables span
    (``core.schedule.build_schedule(...).fill_drain_slots``), kept as one
    definition so the analytic model and the executable schedules cannot
    drift.  Exact only for UNIFORM stage costs; non-uniform stages are
    priced by the executable timetable itself (``pipeline_time`` →
    ``core.schedule.price_schedule``)."""
    return n_micro + n_stages - 1


# fwd : bwd tick split of one stage-microbatch (bwd recomputes the two
# matmul operands -> the canonical 1:2 ratio); the priced makespan of a
# uniform pipeline is invariant to this split (the critical path holds
# fill-count fwd ticks AND fill-count bwd ticks), so the uniform closed
# form stays exact for any fraction.  This is the analytic FALLBACK:
# compiled plans over a differentiated graph measure the real ratio
# from per-phase op FLOPs (``measured_fwd_fraction`` /
# ``CompiledPlan.tick_durations``) and pass it via ``fwd_fraction=``.
FWD_TIME_FRACTION = 1.0 / 3.0


def stage_tick_times(cluster: ClusterSpec, model: ModelSpec, st: Stage,
                     micro_tokens: int, seq_len: int,
                     fwd_fraction: float | None = None
                     ) -> tuple[float, float]:
    """(fwd, bwd) seconds of one microbatch through one stage — the
    non-uniform tick durations the schedule engine prices.
    ``fwd_fraction`` overrides the analytic 1:2 split (e.g. the ratio
    measured from a differentiated graph's real FLOPs)."""
    f = FWD_TIME_FRACTION if fwd_fraction is None else fwd_fraction
    t = stage_micro_time(cluster, model, st, micro_tokens, seq_len)
    return t * f, t * (1.0 - f)


# ---------------------------------------------------------------------------
# measured tick durations from a differentiated graph (autodiff-aware)
# ---------------------------------------------------------------------------

def graph_phase_flops(graph, strategy: int, pipelines,
                      virtual_stages_per_device: int,
                      shapes) -> dict[tuple[int, str], float]:
    """``(virtual stage, phase) -> FLOPs`` of one step, counted from the
    graph's REAL ops: forward ops land in their assigned (virtual)
    stage's ``fwd`` slot, autodiff backward ops in their anchor stage's
    ``bwd`` slot.  This is what replaces the hardcoded fwd:bwd = 1:2
    split once the graph IR carries a backward pass, and it prices each
    interleave CHUNK by its own op count (chunks no longer share their
    physical stage's pricing)."""
    from . import op_semantics
    from .schedule import assign_stages

    stage_of = assign_stages(graph, strategy, pipelines,
                             virtual_stages_per_device)
    n_stages = max((p.n_stages for p in pipelines), default=1)
    out: dict[tuple[int, str], float] = {
        (s, ph): 0.0
        for s in range(n_stages * virtual_stages_per_device)
        for ph in ("fwd", "bwd")}
    for op in graph.ops:
        if op.kind in ("placeholder", "parameter", "comm"):
            continue
        phase = "bwd" if op.attrs.get("phase") == "bwd" else "fwd"
        fl = op_semantics.flops(
            op.kind, [shapes[t.name] for t in op.inputs],
            shapes[op.outputs[0].name], op.attrs)
        out[(stage_of[id(op)], phase)] += fl
    return out


def graph_tick_durations(graph, strategy: int, pipelines,
                         virtual_stages_per_device: int, shapes,
                         flops_per_second: float = 1e12
                         ) -> dict[tuple[int, str], float]:
    """Per-(virtual stage, phase) tick seconds MEASURED from the graph's
    own op FLOPs, for ``core.schedule.price_schedule``.  Every slot is
    present (zero-cost phases price as 0.0 — e.g. ``bwd`` ticks of a
    forward-only graph)."""
    return {k: v / flops_per_second
            for k, v in graph_phase_flops(
                graph, strategy, pipelines,
                virtual_stages_per_device, shapes).items()}


def measured_fwd_fraction(graph, strategy: int, pipelines,
                          virtual_stages_per_device: int, shapes
                          ) -> float:
    """The fwd share of one step's compute FLOPs, measured from a
    differentiated graph (falls back to :data:`FWD_TIME_FRACTION` for
    forward-only graphs, whose bwd FLOPs are zero)."""
    fl = graph_phase_flops(graph, strategy, pipelines,
                           virtual_stages_per_device, shapes)
    fwd = sum(v for (s, ph), v in fl.items() if ph == "fwd")
    bwd = sum(v for (s, ph), v in fl.items() if ph == "bwd")
    if bwd <= 0.0:
        return FWD_TIME_FRACTION
    return fwd / (fwd + bwd)


def _stage_p2p_times(cluster: ClusterSpec, model: ModelSpec,
                     p: PipelineSpec, seq_len: int) -> list[float]:
    """Per-boundary activation transfer seconds for one microbatch."""
    micro_tokens = p.micro_bs * seq_len
    out = []
    for a, b in zip(p.stages[:-1], p.stages[1:]):
        act_bytes = 2 * micro_tokens * model.d_model
        link = cluster.link_gbps(a.ranks[-1], b.ranks[0])
        out.append(act_bytes / (link * 1e9))
    return out


def pipeline_tick_durations(cluster: ClusterSpec, model: ModelSpec,
                            p: PipelineSpec, seq_len: int, *,
                            virtual_stages_per_device: int = 1,
                            fwd_fraction: float | None = None
                            ) -> dict[tuple[int, str], float]:
    """``(virtual stage, phase) -> seconds`` for
    ``core.schedule.price_schedule``.

    Per stage, the steady-state slot must cover both the stage's compute
    and the slowest stage-boundary transfer it has to hide (the schedule
    overlaps sends with the next microbatch's compute), so each tick is
    ``max(stage time, slowest boundary) * phase fraction``.

    With ``virtual_stages_per_device = v > 1`` (Megatron interleaving)
    each physical stage's layers split evenly across its ``v`` chunks,
    so chunk ticks cost ``1/v`` of the stage's compute — per-CHUNK
    pricing instead of chunks inheriting their stage's full cost, which
    is what gives interleaved schedules their genuine ~1/v fill/drain
    advantage when priced.  ``fwd_fraction`` overrides the analytic
    fwd:bwd = 1:2 split (pass a ratio measured from the differentiated
    graph, :func:`measured_fwd_fraction`)."""
    f = FWD_TIME_FRACTION if fwd_fraction is None else fwd_fraction
    v = virtual_stages_per_device
    micro_tokens = p.micro_bs * seq_len
    p2p_max = max(_stage_p2p_times(cluster, model, p, seq_len), default=0.0)
    out: dict[tuple[int, str], float] = {}
    n_stages = len(p.stages)
    for s, st in enumerate(p.stages):
        slot = max(stage_micro_time(cluster, model, st, micro_tokens,
                                    seq_len) / v, p2p_max)
        for c in range(v):
            out[(c * n_stages + s, "fwd")] = slot * f
            out[(c * n_stages + s, "bwd")] = slot * (1.0 - f)
    return out


def pipeline_tick_split(cluster: ClusterSpec, model: ModelSpec,
                        p: PipelineSpec, seq_len: int, *,
                        virtual_stages_per_device: int = 1,
                        fwd_fraction: float | None = None
                        ) -> tuple[dict[tuple[int, str], float],
                                   dict[tuple[int, str], float]]:
    """Split each tick of :func:`pipeline_tick_durations` into its
    ``(compute, comm)`` components for overlap-aware pricing.

    The sync tick ``max(stage/v, p2p_max) * frac`` is decomposed as
    ``compute = (stage/v) * frac`` and ``comm = (slot - stage/v) *
    frac`` — the boundary-transfer time the sync slot serializes on top
    of compute.  By construction ``compute + comm`` equals the sync
    duration exactly, so ``price_schedule(sched, compute, comm=comm)``
    reproduces today's sync makespan bit-for-bit, and since
    ``max(compute, comm) <= compute + comm`` the overlap-priced makespan
    of the same split can never be worse."""
    f = FWD_TIME_FRACTION if fwd_fraction is None else fwd_fraction
    v = virtual_stages_per_device
    micro_tokens = p.micro_bs * seq_len
    p2p_max = max(_stage_p2p_times(cluster, model, p, seq_len), default=0.0)
    comp: dict[tuple[int, str], float] = {}
    comm: dict[tuple[int, str], float] = {}
    n_stages = len(p.stages)
    for s, st in enumerate(p.stages):
        t_stage = stage_micro_time(cluster, model, st, micro_tokens,
                                   seq_len) / v
        hidden = max(t_stage, p2p_max) - t_stage
        for c in range(v):
            for phase, frac in (("fwd", f), ("bwd", 1.0 - f)):
                comp[(c * n_stages + s, phase)] = t_stage * frac
                comm[(c * n_stages + s, phase)] = hidden * frac
    return comp, comm


def pipeline_time(cluster: ClusterSpec, model: ModelSpec, p: PipelineSpec,
                  seq_len: int, kind: str = "1f1b", *,
                  virtual_stages_per_device: int = 1,
                  fwd_fraction: float | None = None,
                  overlap: bool = False) -> float:
    """Seconds for one step of one pipeline, priced from the executable
    timetable: ``core.schedule.build_schedule`` emits the 1F1B/GPipe/
    interleaved tick table the executors would run and
    ``price_schedule`` re-times it under the per-(virtual stage, phase)
    durations above, so heterogeneous stage splits are scored by the
    schedule they'd actually execute (a non-bottleneck fill ramp no
    longer pays bottleneck price).  The fill ramp additionally pays each
    boundary's latency once, when the first microbatch traverses the
    pipeline.

    ``kind="interleaved"`` with ``virtual_stages_per_device = v > 1``
    prices Megatron's virtual-stage timetable under PER-CHUNK tick
    durations (each chunk carries ``1/v`` of its stage's layers), so
    interleaving shows its real ~``1/v`` bubble advantage; at ``v=1``
    it degenerates to the 1F1B table.  ``fwd_fraction`` overrides the
    analytic 1:2 fwd:bwd split with a measured ratio.

    Uniform stage costs (v=1) keep the closed-form fast path
    ``fill_drain_count(m, S) * slot + sum(p2p)`` — asserted equal to the
    priced timetable, so the two definitions cannot drift.

    ``overlap=True`` prices the timetable as the async executor runs
    it: each tick's duration is split into compute and the boundary
    transfer it hides (:func:`pipeline_tick_split`) and the tick costs
    ``max(compute, comm)`` instead of their sum.  The fill-ramp latency
    term is unchanged — overlap hides steady-state transfers behind the
    next microbatch's compute but cannot hide the first microbatch's
    traversal.  Overlap pricing of a pipeline is never worse than sync
    pricing (same split, ``max <= sum`` per tick).
    """
    from .schedule import build_schedule, price_schedule

    if kind not in ("1f1b", "gpipe", "interleaved"):
        raise ValueError(f"unknown schedule kind {kind!r} "
                         f"(have: 1f1b, gpipe, interleaved)")
    v = virtual_stages_per_device
    if v < 1:
        raise ValueError(f"virtual_stages_per_device must be >= 1 "
                         f"(got {v})")
    if v > 1 and kind != "interleaved":
        raise ValueError(
            f"virtual_stages_per_device={v} requires kind='interleaved' "
            f"(got {kind!r})")
    f = FWD_TIME_FRACTION if fwd_fraction is None else fwd_fraction
    micro_tokens = p.micro_bs * seq_len
    times = [stage_micro_time(cluster, model, st, micro_tokens, seq_len)
             for st in p.stages]
    p2p_each = _stage_p2p_times(cluster, model, p, seq_len)
    p2p_max = max(p2p_each, default=0.0)

    def t_priced() -> float:
        if overlap:
            durations, comm = pipeline_tick_split(
                cluster, model, p, seq_len, virtual_stages_per_device=v,
                fwd_fraction=f)
        else:
            durations = pipeline_tick_durations(
                cluster, model, p, seq_len, virtual_stages_per_device=v,
                fwd_fraction=f)
            comm = None
        if kind == "interleaved" and v > 1:
            sched = build_schedule(len(p.stages), p.n_micro,
                                   "interleaved",
                                   virtual_stages_per_device=v)
            # each of the first microbatch's v ring traversals pays the
            # boundary latencies once
            return price_schedule(sched, durations, comm=comm,
                                  overlap=overlap).makespan \
                + v * sum(p2p_each)
        sched = build_schedule(len(p.stages), p.n_micro,
                               "gpipe" if kind == "gpipe" else "1f1b")
        return price_schedule(sched, durations, comm=comm,
                              overlap=overlap).makespan + sum(p2p_each)

    if overlap:
        # the closed-form fast path encodes the SYNC slot; overlap
        # pricing must go through the timetable
        return t_priced()
    if v == 1 and all(t == times[0] for t in times[1:]):  # uniform fast path
        slot = max([times[0]] + p2p_each)
        t_uniform = fill_drain_count(p.n_micro, len(p.stages)) * slot \
            + sum(p2p_each)
        # assertion-only pricing: the O(m*S) tick table is built solely
        # to pin uniform == priced (also regression-tested), and is
        # skipped entirely under python -O
        assert math.isclose(t_priced(), t_uniform, rel_tol=1e-9)
        return t_uniform
    return t_priced()


def dp_sync_time(cluster: ClusterSpec, model: ModelSpec,
                 strat: Strategy) -> float:
    """Cross-pipeline gradient synchronization (hetero DP -> SplitAR).

    Ring all-reduce cost over the per-layer owner groups: each parameter
    byte crosses the slowest link 2(n-1)/n times.
    """
    if len(strat.pipelines) <= 1:
        return 0.0
    total = 0.0
    n_layers = model.n_layers
    for layer in range(n_layers):
        owners = []
        for p in strat.pipelines:
            for st in p.stages:
                if st.layers[0] <= layer < st.layers[1]:
                    owners.append(st)
        if len(owners) <= 1:
            continue
        grad_bytes = model.params_per_layer * 2  # bf16 grads
        ranks = [r for st in owners for r in st.ranks]
        link = min(cluster.link_gbps(a, b)
                   for a in ranks for b in ranks if a != b)
        n = len(owners)
        shard = grad_bytes / max(min(st.tp for st in owners), 1)
        total += 2 * (n - 1) / n * shard / (link * 1e9)
    return total


def step_time(cluster: ClusterSpec, model: ModelSpec, strat: Strategy,
              seq_len: int, *, virtual_stages_per_device: int = 1,
              fwd_fraction: float | None = None,
              overlap: bool = False) -> float:
    """One training step: slowest pipeline + cross-pipeline grad sync.

    ``fwd_fraction`` (the candidate-facing pricing hook used by the
    search subsystem) re-splits each tick's fwd/bwd durations by a
    measured ratio instead of the analytic :data:`FWD_TIME_FRACTION`;
    ``virtual_stages_per_device > 1`` prices the interleaved timetable;
    ``overlap=True`` prices pipelines under the async executor's
    comm/compute overlap (never worse than sync pricing).
    """
    kind = ("interleaved" if virtual_stages_per_device > 1
            else strat.schedule)
    t_pipe = max(pipeline_time(
        cluster, model, p, seq_len, kind=kind,
        virtual_stages_per_device=virtual_stages_per_device,
        fwd_fraction=fwd_fraction, overlap=overlap)
        for p in strat.pipelines)
    return t_pipe + dp_sync_time(cluster, model, strat)


def memory_per_rank(model: ModelSpec, strat: Strategy) -> dict[int, float]:
    """GB of weights(+grads+opt) per rank under the strategy."""
    out: dict[int, float] = {}
    n_dp = len(strat.pipelines)
    for p in strat.pipelines:
        for st in p.stages:
            params = model.params_per_layer * st.n_layers / st.tp
            bytes_per_param = 2 + 2 + (12 / n_dp if strat.zero1 else 12)
            for r in st.ranks:
                out[r] = out.get(r, 0.0) + params * bytes_per_param / 1e9
    return out


def feasible(cluster: ClusterSpec, model: ModelSpec,
             strat: Strategy) -> bool:
    for r, gb in memory_per_rank(model, strat).items():
        if gb > cluster.ranks[r].mem_gb * 0.85:
            return False
    return True


# ---------------------------------------------------------------------------
# simple homogeneous strategy builder (the DeepSpeed/Megatron baselines)
# ---------------------------------------------------------------------------

def uniform_strategy(ranks: list[int], model: ModelSpec, *, dp: int, tp: int,
                     pp: int, global_batch: int, micro_bs: int = 1,
                     zero1: bool = True) -> Strategy:
    assert len(ranks) == dp * tp * pp, (len(ranks), dp, tp, pp)
    per_stage = model.n_layers // pp
    pipelines = []
    idx = 0
    for d in range(dp):
        stages = []
        for s in range(pp):
            grp = tuple(ranks[idx:idx + tp])
            idx += tp
            lo = s * per_stage
            hi = model.n_layers if s == pp - 1 else (s + 1) * per_stage
            stages.append(Stage(grp, (lo, hi)))
        n_micro = max(global_batch // dp // micro_bs, 1)
        pipelines.append(PipelineSpec(tuple(stages), n_micro, micro_bs))
    return Strategy(tuple(pipelines), zero1=zero1)


def best_uniform(cluster: ClusterSpec, model: ModelSpec, ranks: list[int],
                 global_batch: int, seq_len: int) -> tuple[Strategy, float]:
    """Grid-search the best homogeneous strategy (the baselines' tuner)."""
    best = None
    n = len(ranks)
    for tp in (1, 2, 4, 8):
        for pp in (1, 2, 3, 4, 5, 6, 8):
            if n % (tp * pp):
                continue
            dp = n // (tp * pp)
            if model.n_layers < pp or global_batch % dp:
                continue
            for mbs in (1, 2, 4):
                if (global_batch // dp) % mbs:
                    continue
                st = uniform_strategy(ranks, model, dp=dp, tp=tp, pp=pp,
                                      global_batch=global_batch,
                                      micro_bs=mbs)
                if not feasible(cluster, model, st):
                    continue
                t = step_time(cluster, model, st, seq_len)
                if best is None or t < best[1]:
                    best = (st, t)
    if best is None:
        raise RuntimeError("no feasible uniform strategy")
    return best
