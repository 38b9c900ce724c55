"""Execution validation: run the top-k candidates for real.

The cost model ranks candidates analytically; this module checks that
ranking against ACTUAL execution.  Each candidate is turned into a
small proxy training program whose HSPMD annotations realize exactly
the candidate's parallel shape — TP groups column/row-splitting weight
pairs, pipeline stages owning layer-proportional slices of the pair
chain (comm ops at every owner change), DP/hetero pipelines as hsize>1
subgroups with batch slabs (``hdim=0``) and hetero-duplicated weights
whose gradients come back ``hdim=Partial`` (the SplitAR grad path PR 6
made executable) — then trained end to end via
``Program.compile_train`` + ``Session.train_step``, on the numpy
simulator and, when asked, on a ``TorchExecutor`` (every virtual device
one row of stacked buffers on one torch device) or a ``DistExecutor``
(every device on its own ``torch.distributed`` rank), where the reference
runs a ``JaxExecutor`` on forced CPU meshes.

On ranks (``"dist"``) every rank runs ``validate`` with the same
arguments, and every decision must come out the same on every rank, or
the ranks' collectives would part ways: the simulator's timings are rank
0's, shared with every rank before the makespans are priced, and a
candidate that fails on any rank is dropped on every rank before the next
collective.  The report is then the same on every rank.

Measuring is subtle: the SimulatorExecutor serializes every device onto
one CPU, so raw wall time is nearly invariant across dp/pp splits (the
total op work is constant).  Instead the executor records per-tick
PER-DEVICE wall times (``record_ticks=True``) and the validator
re-prices the executed timetable with max-over-devices tick durations
(``price_schedule``) — the parallel makespan a real cluster would see.
For heterogeneous fixtures, each device's time is first scaled by
``ref_tflops / its_tflops`` (the CPU mesh has equal-speed devices; the
projection reintroduces the speed ratio the candidate was priced
under).

Proxy numerics are exact: inputs are small integers and every weight is
a signed selection matrix (one ±1 per column), so activations never
grow, float32 arithmetic stays integer-exact, and sim↔torch losses and
gradients can be compared BITWISE (``resolve_device`` turns TF32 off
on the GPU, so its products are full fp32).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.costmodel import ClusterSpec
from repro_torch.core.schedule import price_schedule

from .rank import RankedCandidate
from .space import Candidate, proportional_split


class ProxyError(ValueError):
    """The candidate's shape cannot be realized as a proxy program."""


def _selection_matrix(rng, rows: int, cols: int, stride: int,
                      offset: int) -> np.ndarray:
    """A (rows, cols) matrix with exactly one ±1 per column: applying it
    permutes/negates columns, so activation magnitudes never grow and
    every product stays exactly representable in float32."""
    w = np.zeros((rows, cols), np.float32)
    for j in range(cols):
        w[(j * stride + offset) % rows, j] = float(
            rng.integers(0, 2) * 2 - 1)
    return w


@dataclass
class ProxyCase:
    """A candidate realized as an executable training program."""

    program: object                     # api.Program
    feeds: dict[str, np.ndarray]
    weights: dict[str, np.ndarray]
    n_devices: int
    rank_of_device: dict[int, int]      # device id -> cluster rank


def proxy_program(cand: Candidate, *, n_pairs: int = 8, d: int = 16,
                  f: int = 32, batch: int = 16,
                  seed: int = 0) -> ProxyCase:
    """Build the candidate-shaped proxy: a chain of ``n_pairs`` relu-MLP
    weight pairs standing in for the model's layers, annotated with the
    candidate's exact TP x PP x DP/hetero shape."""
    from repro_torch import api

    strat = cand.strategy
    if strat is None:
        raise ProxyError(f"{cand.name} was rejected; nothing to execute")
    pipes = strat.pipelines
    n_pipes = len(pipes)
    all_ranks = sorted(r for p in pipes for st in p.stages
                      for r in st.ranks)
    if len(set(all_ranks)) != len(all_ranks):
        raise ProxyError(f"{cand.name}: pipelines share ranks")
    dev_of = {r: i for i, r in enumerate(all_ranks)}
    n_stages = len(pipes[0].stages)
    if any(len(p.stages) != n_stages for p in pipes):
        raise ProxyError(f"{cand.name}: ragged pipeline depths")
    if batch % n_pipes:
        raise ProxyError(f"batch {batch} not divisible by "
                         f"{n_pipes} pipelines")
    # owner physical stage of each weight pair: layer-proportional for
    # v=1 (asymmetric hetero splits show up in the executed shape), the
    # Megatron wrap-around chunk layout for v>1
    if cand.v == 1:
        counts = proportional_split(
            [st.n_layers for st in pipes[0].stages], n_pairs)
        owner = [s for s, c in enumerate(counts) for _ in range(c)]
    else:
        chunks = n_stages * cand.v
        if n_pairs < chunks:
            raise ProxyError(f"{n_pairs} pairs < {chunks} virtual "
                             f"stages")
        owner = [(i * chunks // n_pairs) % n_stages
                 for i in range(n_pairs)]
    grp = [[tuple(dev_of[r] for r in st.ranks) for st in p.stages]
           for p in pipes]
    for s in range(n_stages):
        for p in range(n_pipes):
            tp = len(grp[p][s])
            if f % tp or d % tp:
                raise ProxyError(
                    f"stage tp={tp} does not divide proxy dims "
                    f"d={d}, f={f}")

    def act_annot(s: int):
        groups = [list(grp[p][s]) for p in range(n_pipes)]
        dss = [api.DS({api.DUP: len(g)}) if len(g) > 1 else api.DS({})
               for g in groups]
        if n_pipes == 1:
            return api.spmd(groups[0], dss[0])
        return api.HSPMD(groups, dss, hdim=0)

    def w_annot(s: int, dim: int):
        groups = [list(grp[p][s]) for p in range(n_pipes)]
        dss = [api.DS({dim: len(g)}) if len(g) > 1 else api.DS({})
               for g in groups]
        if n_pipes == 1:
            return api.spmd(groups[0], dss[0])
        return api.HSPMD(groups, dss)       # hdim=DUP: grads -> SplitAR

    rng = np.random.default_rng(seed)
    g = api.Graph()
    x = g.placeholder("X", (batch, d))
    annots = {"X": act_annot(owner[0])}
    feeds = {"X": rng.integers(-3, 4, (batch, d)).astype(np.float32)}
    weights: dict[str, np.ndarray] = {}
    prev = owner[0]
    for i in range(n_pairs):
        s = owner[i]
        if s != prev:                        # stage boundary -> P2P comm
            x = g.comm(x, name=f"T{i}")
            annots[f"T{i}"] = act_annot(s)
            prev = s
        wu = g.parameter(f"Wu{i}", (d, f))
        wd = g.parameter(f"Wd{i}", (f, d))
        annots[f"Wu{i}"] = w_annot(s, 1)     # column-parallel
        annots[f"Wd{i}"] = w_annot(s, 0)     # row-parallel
        weights[f"Wu{i}"] = _selection_matrix(rng, d, f, 3, i)
        weights[f"Wd{i}"] = _selection_matrix(rng, f, d, 5, 2 * i + 1)
        h = g.relu(g.dot(x, wu, name=f"H{i}"), name=f"R{i}")
        y = g.dot(h, wd, name=f"Y{i}")
        tp = len(grp[0][s])
        if tp > 1:                           # resolve the TP Partial
            x = g.comm(y, name=f"A{i}")
            annots[f"A{i}"] = act_annot(s)
        else:
            x = y
    g.sum(g.sum(x, 1, name="L1"), 0, name="L")
    program = api.Program(g, [api.Strategy(cand.name, annots)])
    return ProxyCase(program, feeds, weights, len(all_ranks),
                     {i: r for r, i in dev_of.items()})


def executable_microbatches(cand: Candidate, batch: int,
                            cap: int = 8) -> int:
    """The largest microbatch count <= min(candidate, cap) the proxy can
    actually run: the batch must split into m microbatches AND each
    microbatch must still split across the candidate's pipelines;
    interleaved schedules additionally need m % stages == 0 (or
    m <= stages)."""
    n_pipes = cand.dp if cand.dp else 1
    for m in range(min(max(cand.n_micro, 1), cap), 0, -1):
        if batch % m:
            continue
        if (batch // m) % n_pipes:
            continue
        if cand.v > 1 and m % cand.pp and m > cand.pp:
            continue
        return m
    return 1


# -- measurement -------------------------------------------------------------

def _tick_durations(ticks: dict, scale: dict[int, float] | None
                    ) -> dict[tuple[int, str], float]:
    """(stage, phase) -> the tick's parallel cost, noise-rejected at OP
    granularity: every occurrence of a (stage, phase) key executes the
    same per-device op sequence (same shapes, different microbatch), so
    each op's true cost is the element-wise MIN across the pooled
    microbatch x repeat samples — timing noise is strictly additive and
    per-op spans give it the fewest places to hide.  A device's tick
    cost is the sum of its op minima (speed-scaled for hetero
    projection); the tick's cost is the max over devices: what the
    serialized simulator work would cost running in parallel."""
    out: dict[tuple[int, str], float] = {}
    for key, occurrences in ticks.items():
        mins: dict[int, list[float]] = {}
        for devops in occurrences:
            for dev, samples in devops.items():
                best = mins.get(dev)
                if best is None:
                    mins[dev] = list(samples)
                else:
                    for i in range(min(len(best), len(samples))):
                        if samples[i] < best[i]:
                            best[i] = samples[i]
        out[key] = max(
            sum(ops) * (scale.get(dev, 1.0) if scale else 1.0)
            for dev, ops in mins.items())
    return out


@dataclass
class ExecutedCandidate:
    """One candidate's execution-validation outcome."""

    ranked: RankedCandidate
    m: int = 1
    schedule: str = "1f1b"
    measured_wall_s: float | None = None       # serialized wall clock
    measured_makespan_s: float | None = None   # re-priced parallel time
    projected_makespan_s: float | None = None  # speed-scaled (hetero)
    proxy_predicted_s: float | None = None     # plan's own timetable
    loss: float | None = None
    bit_exact: bool | None = None    # sim vs torch / dist (None: sim only)
    error: str | None = None

    @property
    def name(self) -> str:
        return self.ranked.name

    @property
    def candidate(self) -> Candidate:
        return self.ranked.candidate

    @property
    def predicted_s(self) -> float:
        return self.ranked.predicted_step_s

    def describe(self) -> str:
        if self.error:
            return f"{self.name}: SKIPPED ({self.error})"
        mk = self.projected_makespan_s or self.measured_makespan_s
        bits = "" if self.bit_exact is None else \
            (" bit-exact" if self.bit_exact else " MISMATCH")
        return (f"{self.name}: predicted {self.predicted_s * 1e3:.3f} ms,"
                f" measured makespan "
                f"{(mk or 0.0) * 1e3:.3f} ms (m={self.m}){bits}")


@dataclass
class ValidationReport:
    executed: tuple[ExecutedCandidate, ...]
    speed_projected: bool
    #: this rank's traffic in the ``"dist"`` bit-exactness runs
    #: (``LoweringStats``), or ``None``; left out of comparisons
    traffic: object = field(default=None, compare=False)

    def _comparable(self) -> list[ExecutedCandidate]:
        return [e for e in self.executed if e.error is None
                and (e.projected_makespan_s if self.speed_projected
                     else e.measured_makespan_s) is not None]

    def agreement(self, tol: float = 0.05) -> float | None:
        """Pairwise concordance of predicted vs measured ordering over
        the validated candidates (1.0 = identical order).  Pairs whose
        predicted OR measured times are within ``tol`` relative
        difference count as concordant — near-ties carry no ordering
        information either way."""
        items = [(e.predicted_s,
                  e.projected_makespan_s if self.speed_projected
                  else e.measured_makespan_s)
                 for e in self._comparable()]
        n = len(items)
        if n < 2:
            return None
        good = total = 0
        for i in range(n):
            for j in range(i + 1, n):
                (pi, mi), (pj, mj) = items[i], items[j]
                total += 1
                close_pred = abs(pi - pj) <= tol * max(pi, pj)
                close_meas = abs(mi - mj) <= tol * max(mi, mj)
                if close_pred or close_meas or \
                        ((pi < pj) == (mi < mj)):
                    good += 1
        return good / total

    def summary(self) -> str:
        ag = self.agreement()
        lines = [f"validated {len(self._comparable())}/"
                 f"{len(self.executed)} candidate(s); ordering "
                 f"agreement {'n/a' if ag is None else f'{ag:.2f}'}"
                 + (" (speed-projected)" if self.speed_projected
                    else "")]
        lines += ["  " + e.describe() for e in self.executed]
        return "\n".join(lines)


def validate(cluster: ClusterSpec, ranked: list[RankedCandidate], *,
             top_k: int = 3, executors=("sim",), device=None, mesh=None,
             repeats: int = 3, batch: int = 16, n_pairs: int = 8,
             d: int = 16, f: int = 32, max_micro: int = 8,
             speed_project: bool | None = None,
             seed: int = 0) -> ValidationReport:
    """Execute the top-k ranked candidates as proxy training programs
    and compare cost-model ordering against measured makespans.

    ``executors=("sim", "torch")`` additionally runs each candidate on a
    ``TorchExecutor(device)`` (``None`` meaning ``cuda``), and
    ``("sim", "dist")`` on a ``DistExecutor(mesh, device=device)`` across
    the ranks (``mesh=None``: one over the world group), called on every
    rank; either checks the first step's loss and every weight gradient
    BITWISE against the simulator, as the reference's ``("sim", "jax")``
    does on its JaxExecutor; ``"jax"`` raises.
    """
    from repro_torch import api

    import statistics

    unknown = set(executors) - {"sim", "torch", "dist"}
    if unknown:
        raise NotImplementedError(
            f"executors {sorted(unknown)}: the port validates on the "
            f"simulator ('sim'), the TorchExecutor ('torch') and the rank "
            f"executor ('dist')")
    # made before any candidate runs, so a missing GPU raises here
    checks = []
    if "torch" in executors:
        checks.append(api.TorchExecutor(device))
    dist_ex = None
    if "dist" in executors:
        dist_ex = api.DistExecutor(mesh, device=device)
        checks.append(dist_ex)

    if speed_project is None:
        speed_project = len({dt.tflops for dt in cluster.ranks}) > 1
    ref = max(dt.tflops for dt in cluster.ranks)

    # phase 1: realize every candidate as a proxy session
    out: list[ExecutedCandidate] = []
    runners: list[dict] = []
    for rc in ranked[:top_k]:
        cand = rc.candidate
        try:
            proxy = proxy_program(cand, n_pairs=n_pairs, d=d, f=f,
                                  batch=batch, seed=seed)
        except (ProxyError, ValueError) as e:
            out.append(ExecutedCandidate(rc, error=f"proxy: {e}"))
            continue
        m = executable_microbatches(cand, batch, cap=max_micro)
        kind = "interleaved" if cand.v > 1 else "1f1b"
        entry = ExecutedCandidate(rc, m=m, schedule=kind)
        out.append(entry)
        sess = api.Session(proxy.program, 0,
                           executor=api.SimulatorExecutor(
                               record_ticks=True))
        sess.load(proxy.weights)
        runners.append(dict(entry=entry, proxy=proxy, sess=sess, m=m,
                            kind=kind, walls=[], ticks={}, sched=None))

    # phase 2: measured steps ROUND-ROBIN across candidates (+1 warmup
    # round), so a load spike on the shared CPU hits every candidate's
    # sample pool instead of biasing whichever was measured then
    for rep in range(1 + repeats):
        for run in runners:
            entry = run["entry"]
            if entry.error is not None:
                continue
            try:
                t0 = time.perf_counter()
                r = run["sess"].train_step(
                    run["proxy"].feeds, num_microbatches=run["m"],
                    schedule=run["kind"])
                dt = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 - isolate candidates
                entry.error = f"{type(e).__name__}: {e}"
                continue
            if rep == 0:            # warmup: numpy caches, compiles
                entry.loss = r.loss
                run["sched"] = r.schedule
                continue
            run["walls"].append(dt)
            rec = run["sess"].executor.last_tick_device_seconds
            for key, occurrences in rec.items():
                run["ticks"].setdefault(key, []).extend(occurrences)
    if dist_ex is not None:
        _share_measurements(runners)
    runners = [run for run in runners if run["entry"].error is None]

    # phase 3: re-price each candidate's executed timetable
    calibration: float | None = None
    for run in runners:
        entry, proxy = run["entry"], run["proxy"]
        entry.measured_wall_s = statistics.median(run["walls"])
        if run["ticks"] and run["sched"] is not None:
            raw = _tick_durations(run["ticks"], None)
            entry.measured_makespan_s = price_schedule(
                run["sched"], lambda s, ph: raw.get((s, ph), 0.0)
            ).makespan
            if speed_project:
                scale = {dev: ref / cluster.ranks[r].tflops
                         for dev, r in proxy.rank_of_device.items()}
                proj = _tick_durations(run["ticks"], scale)
                entry.projected_makespan_s = price_schedule(
                    run["sched"], lambda s, ph: proj.get((s, ph), 0.0)
                ).makespan
        else:
            # m=1 runs have no timetable: approximate the parallel
            # makespan as serialized wall time over the device count
            entry.measured_makespan_s = \
                entry.measured_wall_s / max(proxy.n_devices, 1)
        try:
            tplan = proxy.program.compile_train(0,
                                                num_microbatches=run["m"])
            base = tplan.predicted_step_seconds(run["m"], run["kind"])
            if calibration is None and entry.measured_makespan_s:
                calibration = base / entry.measured_makespan_s
            if calibration:
                entry.proxy_predicted_s = base / calibration
            if checks:
                # every check runs (no short cut): a rank executor's runs
                # are collective
                same = [_bit_exact(api, proxy, ex, run["m"], run["kind"])
                        for ex in checks]
                entry.bit_exact = all(same)
        except Exception as e:  # noqa: BLE001 - isolate candidates
            entry.error = f"{type(e).__name__}: {e}"
        if dist_ex is not None:
            _agree(entry)
    return ValidationReport(tuple(out), speed_project,
                            dist_ex.traffic() if dist_ex else None)


def _gather(value) -> list:
    """``value`` from every rank of the world group, by rank."""
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, value)
    return every


def _share_measurements(runners: list[dict]) -> None:
    """Make phase 2's outcome the same on every rank: each candidate's
    timings become rank 0's, and a candidate that failed on any rank
    fails on every rank with the first such rank's error."""
    every = _gather([(run["entry"].error, run["walls"], run["ticks"])
                     for run in runners])
    for i, run in enumerate(runners):
        errors = [rk[i][0] for rk in every if rk[i][0] is not None]
        if errors:
            run["entry"].error = errors[0]
        run["walls"], run["ticks"] = every[0][i][1], every[0][i][2]


def _agree(entry: ExecutedCandidate) -> None:
    """Make a candidate's phase 3 outcome the same on every rank: an error
    on any rank drops it on every rank; it is bit-exact only where it is
    on every rank."""
    every = _gather((entry.error, entry.bit_exact))
    errors = [e for e, _ in every if e is not None]
    if errors:
        entry.error, entry.bit_exact = errors[0], None
    else:
        entry.bit_exact = all(b for _, b in every)


def _bit_exact(api, proxy: ProxyCase, executor, m: int, kind: str) -> bool:
    """One fresh train step on the simulator and on ``executor``; loss
    and every gradient must match BITWISE (the proxy arithmetic is
    integer-exact)."""
    results = []
    for ex in (api.SimulatorExecutor(), executor):
        sess = api.Session(proxy.program, 0, executor=ex)
        sess.load(proxy.weights)
        results.append(sess.train_step(proxy.feeds, num_microbatches=m,
                                       schedule=kind))
    a, b = results
    if a.loss != b.loss:
        return False
    return all(np.array_equal(a.grad_value(p), b.grad_value(p))
               for p in a.grads)
