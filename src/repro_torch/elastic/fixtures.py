"""The elastic *probe* fixture: a tiny training program whose weight
trajectory is **bitwise invariant** across parallel strategies,
microbatch counts, and executors.

Why it works: the loss is ``L = sum(X @ W1 + X @ W2)`` (two pipeline-able
stages joined by an add), so every weight gradient is
``dW = X^T @ ones`` — *weight-independent* small integers.  Cross-device
gradient reductions therefore sum exact integers (order-free in float32
below 2**24), AdamW's per-element update is deterministic IEEE
arithmetic on bitwise-identical inputs, and the grad-norm clip scale is
computed from an exact integer sum of squares.  The weights, optimizer
m/v, and gradients of ANY strategy / microbatch count / executor are
bit-identical at every step — the elastic driver's differential oracle.
Only the LOSS value (a sum of float activations) is
reduction-order-dependent and compares to float tolerance.

The port's copy of ``repro/elastic/fixtures.py``, shared by the port's
tests and ``chip_smoke.py`` (same one-definition rule as
:mod:`repro_torch.api.testing`).  Import is side-effect free.
"""

from __future__ import annotations

import numpy as np

from repro_torch import api

BATCH, DIM = 16, 8
LAYOUTS = ("dp", "pp", "hetero", "single")


def probe_graph() -> "api.Graph":
    """``L = sum(X @ W1 + X @ W2)`` with comm ops slicing it into two
    annotatable halves (W1's stage feeds ``H2``/``X2`` to W2's)."""
    g = api.Graph()
    g.placeholder("X", (BATCH, DIM))
    g.parameter("W1", (DIM, DIM))
    h = g.dot(g.tensors["X"], g.tensors["W1"], name="H")
    g.comm(h, name="H2")
    g.comm(g.tensors["X"], name="X2")
    g.parameter("W2", (DIM, DIM))
    y = g.dot(g.tensors["X2"], g.tensors["W2"], name="Y")
    s = g.add(g.tensors["H2"], y, name="S")
    g.sum(g.sum(s, 1, name="L1"), 0, name="L")
    return g


def _row(k: int) -> "api.DS":
    return api.DS({0: k}) if k > 1 else api.DS({})


def _dup(k: int) -> "api.DS":
    return api.DS({api.DUP: k}) if k > 1 else api.DS({})


def layout_name(kind: str, ranks) -> str:
    return f"{kind}[{','.join(str(r) for r in ranks)}]"


def probe_layout(ranks, kind: str = "dp") -> "api.Strategy":
    """One of the probe's strategy classes on an explicit device set:

    * ``"dp"`` — pure data parallel: activations row-split over all
      ranks, weights replicated (grad-reduce = all-reduce).
    * ``"pp"`` — 2-stage pipeline: W1's stage on the first half of the
      ranks, W2's on the rest, activations row-split within a stage.
    * ``"hetero"`` — hsize=2 HSPMD: two subgroups each own a batch slab
      (hdim=0); the first row-splits its slab, the second duplicates it
      (grads resolve through the two-tier SplitAR path).
    * ``"single"`` — everything on ``ranks[0]``.
    """
    ranks = list(ranks)
    n = len(ranks)
    name = layout_name(kind, ranks)
    if kind == "single" or n == 1:
        r = [ranks[0]]
        one = api.DS({})
        annots = {t: api.spmd(r, one)
                  for t in ("X", "W1", "H2", "X2", "W2")}
        return api.Strategy(layout_name("single", r), annots)
    if kind == "dp":
        annots = {
            "X": api.spmd(ranks, _row(n)),
            "W1": api.spmd(ranks, _dup(n)),
            "H2": api.spmd(ranks, _row(n)),
            "X2": api.spmd(ranks, _row(n)),
            "W2": api.spmd(ranks, _dup(n)),
        }
        return api.Strategy(name, annots)
    if kind == "pp":
        half = (n + 1) // 2
        s0, s1 = ranks[:half], ranks[half:]
        annots = {
            "X": api.spmd(s0, _row(len(s0))),
            "W1": api.spmd(s0, _dup(len(s0))),
            "H2": api.spmd(s1, _row(len(s1))),
            "X2": api.spmd(s1, _row(len(s1))),
            "W2": api.spmd(s1, _dup(len(s1))),
        }
        return api.Strategy(name, annots)
    if kind == "hetero":
        if n % 2:
            raise ValueError(f"hetero layout needs an even rank count "
                             f"(got {n})")
        h = n // 2
        groups = [ranks[:h], ranks[h:]]
        annots = {
            "X": api.HSPMD(groups, [_row(h), _dup(h)], hdim=0),
            "W1": api.HSPMD(groups, [_dup(h), _dup(h)]),
            "H2": api.HSPMD(groups, [_dup(h), _row(h)], hdim=0),
            "X2": api.HSPMD(groups, [_dup(h), _row(h)], hdim=0),
            "W2": api.HSPMD(groups, [_dup(h), _dup(h)]),
        }
        return api.Strategy(name, annots)
    raise ValueError(f"unknown probe layout {kind!r}; have {LAYOUTS}")


def probe_values(seed: int = 3) -> dict[str, np.ndarray]:
    """Integer initial weights."""
    rng = np.random.default_rng(seed)
    return {"W1": rng.integers(-4, 5, (DIM, DIM)).astype(np.float32),
            "W2": rng.integers(-4, 5, (DIM, DIM)).astype(np.float32)}


def probe_feeds(step: int) -> dict[str, np.ndarray]:
    """Deterministic per-step integer batch — the same logical batch
    schedule regardless of which devices are alive, so an elastic run
    and an uninterrupted reference see identical data."""
    rng = np.random.default_rng(10_000 + step)
    return {"X": rng.integers(-4, 5, (BATCH, DIM)).astype(np.float32)}


def probe_provider(default: str = "dp", max_width: int = 8):
    """``(ranks, layout=None) -> api.Strategy`` for the driver: honors a
    per-event layout hint, degrading to a feasible class when the rank
    count cannot host it.  Shard widths must divide the (micro)batch, so
    the provider uses the largest power-of-two prefix of the ranks (at
    most ``max_width``; pass ``BATCH // (2 * m)`` when running ``m``
    microbatches) — surplus devices idle, like a real system dropping
    stragglers that don't fill a shard group."""
    def provider(ranks, layout: str | None = None) -> "api.Strategy":
        kind = layout or default
        n = min(len(ranks), max_width)
        n = 1 << (n.bit_length() - 1)        # largest power of two <= n
        use = list(ranks)[:n]
        if n == 1:
            kind = "single"
        elif kind == "hetero" and n % 2:
            kind = "dp"
        return probe_layout(use, kind)
    return provider


class SearchProvider:
    """A driver provider that re-SELECTS through :class:`repro_torch.search.
    Searcher` on every transition: the searcher picks the best cost-model strategy for
    the surviving ranks, and its *shape* (pipelined or not) is realized
    as the matching probe layout.  Selections are recorded on
    ``self.selections`` for inspection."""

    def __init__(self, searcher=None, cluster=None, max_rank: int = 8):
        from repro_torch.search import Searcher, cpu_cluster, tiny_spec
        self.searcher = searcher or Searcher(
            tiny_spec(), global_batch=8, seq_len=128,
            tp_options=(1, 2), pp_options=(1, 2),
            pipeline_options=(1,), virtual_options=(1,),
            include_hetero=False)
        self.cluster = cluster or cpu_cluster(max_rank)
        self.selections: list = []

    def __call__(self, ranks, layout: str | None = None) -> "api.Strategy":
        if layout is not None:          # explicit hint wins
            return probe_provider()(ranks, layout)
        sel = self.searcher.select_candidate(self.cluster, list(ranks))
        self.selections.append(sel)
        cand = sel.candidate
        pipelined = cand is not None and any(
            len(p.stages) > 1 for p in cand.strategy.pipelines)
        kind = "pp" if pipelined and len(ranks) > 1 else "dp"
        return probe_provider()(ranks, kind)


def reference_run(strategy: "api.Strategy", n_steps: int, *,
                  executor, num_microbatches: int = 1,
                  schedule: str = "1f1b", seed: int = 3,
                  feeds=probe_feeds):
    """The differential oracle's dense side: ``n_steps`` uninterrupted
    ``train_step``s under ONE strategy.  Returns ``(session, losses)``;
    the probe's invariance means ``session.weights`` / ``opt_state``
    must be bitwise equal to any elastic trajectory of the same length.
    ``executor`` names where the oracle runs (the port's tests and
    ``chip_smoke.py`` pass the numpy ``SimulatorExecutor``).
    """
    program = api.Program(probe_graph(), [strategy])
    session = api.Session(program, strategy.name, executor=executor)
    session.load(probe_values(seed))
    losses = []
    for s in range(n_steps):
        r = session.train_step(feeds(s),
                               num_microbatches=num_microbatches,
                               schedule=schedule)
        losses.append(r.loss)
    return session, losses


__all__ = ["BATCH", "DIM", "LAYOUTS", "SearchProvider", "layout_name",
           "probe_feeds", "probe_graph", "probe_layout", "probe_provider",
           "probe_values", "reference_run"]
