"""Shared differential-test fixtures for the `repro.api` surface.

Lives in ``src/`` (not ``tests/``) because the same program builders are
consumed by both the pytest suite and the subprocess runtime selftest
(``repro.runtime.selftest``) — one definition, so the two can never
drift apart.  Import is side-effect free (no jax, no device forcing).
"""

from __future__ import annotations

import numpy as np

from repro_torch import api


def zigzag_program(n: int = 4, name: str = "zig") -> "api.Program":
    """A 2-physical-stage program whose dataflow crosses the stage
    boundary three times (s0 -> s1 -> s0 -> s1): Megatron's v=2
    interleaved chunk layout, expressible only as virtual stages.

    Devices ``0..n/2-1`` form stage 0, the rest stage 1; activations are
    row-split within a stage (every stage-0 device is a P2P sender, so
    pipeline construction sees symmetric parallel chains).
    """
    half = n // 2
    s0, s1 = list(range(half)), list(range(half, n))
    row = api.DS({0: half}) if half > 1 else api.DS({})
    dup = api.DS({api.DUP: half})
    g = api.Graph()
    g.placeholder("X", (16, 16))
    g.parameter("W1", (16, 12))
    h = g.relu(g.dot(g.tensors["X"], g.tensors["W1"], name="H0"),
               name="H")
    g.comm(h, name="H2")                     # -> stage 1   (chunk 0)
    g.parameter("W2", (12, 10))
    y1 = g.dot(g.tensors["H2"], g.tensors["W2"], name="Y1")
    g.comm(y1, name="Y2")                    # -> stage 0   (chunk 1!)
    g.parameter("W3", (10, 8))
    y4 = g.relu(g.dot(g.tensors["Y2"], g.tensors["W3"], name="Y3"),
                name="Y4")
    g.comm(y4, name="Y5")                    # -> stage 1   (chunk 1)
    g.parameter("W4", (8, 6))
    y = g.dot(g.tensors["Y5"], g.tensors["W4"], name="Y")
    g.sum(g.sum(y, 1, name="L1"), 0, name="L")
    strat = api.Strategy(name, {
        "X": api.spmd(s0, row), "W1": api.spmd(s0, dup),
        "H2": api.spmd(s1, row), "W2": api.spmd(s1, dup),
        "Y2": api.spmd(s0, row), "W3": api.spmd(s0, dup),
        "Y5": api.spmd(s1, row), "W4": api.spmd(s1, dup),
    })
    return api.Program(g, [strat])


def loss_pipeline_program(n: int = 4, name: str = "pipe") -> "api.Program":
    """The canonical 2-stage loss pipeline of the selftest suite:
    ``L = sum(relu(X @ W1) @ W2)`` with stage 0 column-parallel over the
    first half of the devices and stage 1 row-parallel over the second
    half — scalar loss, so it trains end-to-end via
    ``Session.train_step``."""
    half = n // 2
    s0, s1 = list(range(half)), list(range(half, n))
    col = api.DS({1: half}) if half > 1 else api.DS({})
    row = api.DS({0: half}) if half > 1 else api.DS({})
    g = api.Graph()
    g.placeholder("X", (16, 16))
    g.parameter("W1", (16, 12))
    h = g.relu(g.dot(g.tensors["X"], g.tensors["W1"], name="H0"),
               name="H")
    g.comm(h, name="H2")
    g.parameter("W2", (12, 6))
    y = g.dot(g.tensors["H2"], g.tensors["W2"], name="Y")
    g.sum(g.sum(y, 1, name="L1"), 0, name="L")
    strat = api.Strategy(name, {
        "X": api.spmd(s0, api.DS({api.DUP: half})),
        "W1": api.spmd(s0, col),
        "H2": api.spmd(s1, row),
        "W2": api.spmd(s1, api.DS({api.DUP: half})),
    })
    return api.Program(g, [strat])


def loss_pipeline_values(seed: int = 11):
    """Integer-valued leaves for :func:`loss_pipeline_program` (exact
    under float32 sums -> bitwise-comparable pipelined gradients) plus
    the expected ``Y`` and loss."""
    rng = np.random.default_rng(seed)
    xv = rng.integers(-4, 5, (16, 16)).astype(np.float32)
    w1v = rng.integers(-4, 5, (16, 12)).astype(np.float32)
    w2v = rng.integers(-4, 5, (12, 6)).astype(np.float32)
    want_y = np.maximum(xv @ w1v, 0) @ w2v
    return xv, {"W1": w1v, "W2": w2v}, want_y


def hetero_program(name: str = "het") -> "api.Program":
    """An hsize=2 (heterogeneous-subgroup, paper §3.2 top tier) training
    fixture over 4 devices: subgroup ``[0, 1]`` row-splits its batch
    slab of ``X`` while subgroup ``[2, 3]`` duplicates its slab (and the
    activation CommOp ``H2`` swaps those bottom-tier layouts across the
    slab boundary), with every weight hetero-duplicated.

    The weight gradients therefore come out ``hdim=Partial`` — each
    subgroup holds the summand contributed by its batch slab, with a
    further bottom-tier Partial inside whichever subgroup row-split its
    activations — so the grad-reduce CommOp must resolve the full
    two-tier reduction (bottom AR inside the split subgroup, then a
    top-tier SplitAR across subgroups) and both executors must execute
    it: the hsize>1 gradient path, end to end."""
    g = api.Graph()
    g.placeholder("X", (16, 16))
    g.parameter("W1", (16, 12))
    h = g.relu(g.dot(g.tensors["X"], g.tensors["W1"], name="H0"),
               name="H")
    g.comm(h, name="H2")
    g.parameter("W2", (12, 6))
    y = g.dot(g.tensors["H2"], g.tensors["W2"], name="Y")
    g.sum(g.sum(y, 1, name="L1"), 0, name="L")
    dup2 = api.DS({api.DUP: 2})
    strat = api.Strategy(name, {
        "X": api.HSPMD([[0, 1], [2, 3]], [api.DS({0: 2}), dup2], hdim=0),
        "W1": api.HSPMD([[0, 1], [2, 3]], [dup2, dup2]),
        "H2": api.HSPMD([[0, 1], [2, 3]], [dup2, api.DS({0: 2})], hdim=0),
        "W2": api.HSPMD([[0, 1], [2, 3]], [dup2, dup2]),
    })
    return api.Program(g, [strat])


def hetero_values(seed: int = 7):
    """Integer-valued leaves for :func:`hetero_program` plus the exact
    expected loss and weight gradients (graph-IR ``relu_grad`` uses the
    ``x > 0`` subgradient at exact zeros — integer data hits them)."""
    rng = np.random.default_rng(seed)
    xv = rng.integers(-4, 5, (16, 16)).astype(np.float32)
    ws = {"W1": rng.integers(-4, 5, (16, 12)).astype(np.float32),
          "W2": rng.integers(-4, 5, (12, 6)).astype(np.float32)}
    h0 = xv @ ws["W1"]
    hh = np.maximum(h0, 0)
    want_loss = float((hh @ ws["W2"]).sum())
    d_y = np.ones((16, 6), np.float32)
    d_h = (d_y @ ws["W2"].T) * (h0 > 0)
    want_grads = {"W1": xv.T @ d_h, "W2": hh.T @ d_y}
    return xv, ws, want_loss, want_grads


def zigzag_values(seed: int = 11):
    """Integer-valued leaves (exact under float32 summation) and the
    expected full-batch ``Y`` for :func:`zigzag_program`."""
    rng = np.random.default_rng(seed)
    xv = rng.integers(-4, 5, (16, 16)).astype(np.float32)
    ws = {f"W{i}": rng.integers(-2, 3, shp).astype(np.float32)
          for i, shp in [(1, (16, 12)), (2, (12, 10)), (3, (10, 8)),
                         (4, (8, 6))]}
    want_y = np.maximum(xv @ ws["W1"], 0) @ ws["W2"]
    want_y = np.maximum(want_y @ ws["W3"], 0) @ ws["W4"]
    return xv, ws, want_y


__all__ = ["hetero_program", "hetero_values",
           "loss_pipeline_program", "loss_pipeline_values",
           "zigzag_program", "zigzag_values"]
