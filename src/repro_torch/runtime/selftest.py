"""Differential self-test of the rank executor against the simulator.

The counterpart of ``repro/runtime/selftest.py:run_all``, run once per
rank under ``runtime.harness.run_ranks``::

    PYTHONPATH=src python -c "from repro_torch.runtime.harness import \\
        run_ranks; print(run_ranks('repro_torch.runtime.selftest', 4, \\
        backend='gloo', device='cpu')[0].stdout)"

With ``n`` ranks (2, 4 or 8) it checks, bit for bit against the port's
simulator (``core.simulator.apply_plan`` and ``api.SimulatorExecutor``):

* ``comm`` cases: a plan resolving to each CommStep kind (ID, SR, AR, RS,
  AG, SplitAR, SplitRS, SplitAG, BSR, Slice) over ``n`` devices, on random
  normal shards (``reduction="exact"``) and on integer shards
  (``reduction="fast"``); the paper's Fig 9 multi-step stage (7 devices,
  ``n >= 7``); a non-uniform ``hsplits`` stage (``n >= 4``); resharding
  round trips,
  each kind case reports its lowering's tier counts (uniform reduce and
  copy stages, stages, copy pairs, rounds); ``grouped:reduce/4``, a
  SplitAR whose reduce groups all run on subgroup collectives
  (``n >= 4``); ``fusion:stats/n``, the full-mesh AG as one uniform
  gather stage and an AG over ``n/2`` devices on the general path's
  fused rounds (``n >= 4``),
* ``api`` cases: ``api:session/n``, ``api:pipeline/n``,
  ``api:pipeline/interleavedn``, ``api:train/n`` and
  ``api:train/interleavedn`` (the zigzag program trained under the
  interleaved schedule at m = 1, 2, 4) through ``api.DistExecutor``;
  ``switch:dist/n``, the fused-BSR weight migration through
  ``core.switching.execute_switch(backend="dist")``; and, at ``n >= 4``,
  ``api:train/hetero4`` (the hsize=2 gradient path: a bottom AR, then a
  top SplitAR, against the dense numpy gradients) and the three
  ``elastic:trace/*`` traces through ``elastic.ElasticDriver`` against an
  uninterrupted run,
* ``async`` cases: ``async:pipeline/n`` (the loss pipeline's ``Y`` and
  ``L`` at m = 1, 2, 4 under 1f1b, gpipe and interleaved) through
  ``api.DistAsyncExecutor``, async and serialized, against the simulator
  and ``api.DistExecutor`` on the same ranks, with the per-stage
  programs (``2 x n_virtual`` over the ranks) and the ``p2p`` and
  ``reduce`` channels checked; and, at ``n = 4``, ``async:train/4`` (the
  loss pipeline trained at (m, schedule) (1, 1f1b), (2, 1f1b), (4, 1f1b),
  (4, gpipe), and the v=2 zigzag at m = 1, 2, 4: losses, gradient and
  updated weight shards),
* ``search`` cases, at ``n = 4``: ``search:hetero/4``, the strategy
  search for a 2-fast + 2-slow CPU cluster validating its top three
  candidates on ``("sim", "dist")``: three executed, all bit-exact,
  ordering agreement at least 2/3, a ``hetero`` winner, and the same
  validation report on every rank.

With ``--out DIR`` rank 0 writes each case's inputs and output shards to
``DIR/<case>.npz`` (keys ``<label>|<tensor>|<device>``), for a checker in
another process (the JAX package's tests) to hold against its own
simulator.  Rank 0 prints one line per case and one
``RUNTIME_SELFTEST_JSON {...}`` line: each case's ``ok``, its plan's step
kinds, and the traffic of its plans summed over the ranks (point-to-point
messages and bytes, collectives, bytes staged through host memory; for
an api case, its ``DistExecutor`` runs' plans and fetches; for an async
case, its ``DistAsyncExecutor`` runs'; for the search case, its
``DistExecutor`` bit-exactness runs').  Every case of the reference's
selftest runs here.  The sweep stops at the first case that fails on a
rank; that rank prints its report and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import traceback

import numpy as np

SHAPE = (16, 8)
KINDS = ("ID", "SR", "AR", "RS", "AG", "SplitAR", "SplitRS", "SplitAG",
         "BSR", "Slice")
TRAFFIC = ("p2p_messages", "p2p_bytes", "collectives", "staged_bytes")
PIPE_RUNS = [(1, "1f1b"), (2, "1f1b"), (4, "1f1b"), (4, "gpipe"),
             (2, "interleaved"), (4, "interleaved")]
TRAIN_RUNS = [(1, "1f1b"), (2, "1f1b"), (4, "gpipe")]
#: the reference's ``async:pipeline/n`` runs (m, schedule) and
#: ``async:train/4`` runs of the loss pipeline
ASYNC_PIPE_RUNS = [(1, "1f1b")] + [(m, kind) for m in (2, 4)
                                   for kind in ("1f1b", "gpipe",
                                                "interleaved")]
ASYNC_TRAIN_RUNS = [(1, "1f1b"), (2, "1f1b"), (4, "1f1b"), (4, "gpipe")]
GROUPS = ("comm", "api", "async", "search")
#: the lowering's static counts that the rank path shares with the
#: stacked one (``LoweringStats``)
TIERS = ("uniform_reduce_stages", "uniform_copy_stages", "stages",
         "copy_pairs", "permute_rounds")
#: the reference's elastic traces (``repro/runtime/selftest.py``):
#: ``(step, devices, layout)`` events, with the transition kinds expected
ELASTIC_TRACES = {
    "elastic:trace/4to2": ([(0, (0, 1, 2, 3), "dp"), (2, (0, 1), "dp"),
                            (4, (0, 1), "pp")], ["shrink", "class-change"]),
    "elastic:trace/2to4": ([(0, (0, 1), "dp"), (2, (0, 1, 2, 3), "dp"),
                            (4, (0, 1, 2, 3), "pp")],
                           ["grow", "class-change"]),
    "elastic:trace/hetero": ([(0, (0, 1, 2, 3), "dp"),
                              (2, (0, 1, 2, 3), "hetero"),
                              (4, (0, 1), "dp")],
                             ["class-change", "shrink"]),
}
ELASTIC_STEPS = 6


def _api():
    from repro_torch import api
    return api


def kind_cases(n: int, a=None) -> dict:
    """(src, dst) pairs over n devices resolving to each operator kind
    (``repro/runtime/selftest.py:kind_cases``), built from the annotation
    types of ``a`` (the port's ``api`` by default, or the JAX package's)."""
    a = a or _api()
    devs = list(range(n))
    half = n // 2
    g0, g1 = devs[:half], devs[half:]
    DS, DUP, PARTIAL, HSPMD, spmd = a.DS, a.DUP, a.PARTIAL, a.HSPMD, a.spmd
    row = DS({0: half}) if half > 1 else DS({})
    col = DS({1: half}) if half > 1 else DS({})
    return {
        "ID": (spmd(devs, DS({0: n})), spmd(devs, DS({0: n}))),
        "SR": (spmd(devs, DS({0: n})),
               spmd(list(reversed(devs)), DS({0: n}))),
        "AR": (spmd(devs, DS({PARTIAL: n})), spmd(devs, DS({DUP: n}))),
        "RS": (spmd(devs, DS({PARTIAL: n})), spmd(devs, DS({0: n}))),
        "AG": (spmd(devs, DS({0: n})), spmd(devs, DS({DUP: n}))),
        "BSR": (spmd(devs, DS({0: n})), spmd(devs, DS({1: n}))),
        "SplitAR": (HSPMD([g0, g1], [row, row], hdim=PARTIAL),
                    HSPMD([g0, g1], [row, row], hdim=DUP)),
        "SplitRS": (HSPMD([g0, g1], [row, row], hdim=PARTIAL),
                    HSPMD([g0, g1], [row, row], hdim=0)),
        "SplitAG": (HSPMD([g0, g1], [row, row], hdim=0),
                    HSPMD([g0, g1], [row, row], hdim=DUP)),
        "Slice": (HSPMD([g0, g1], [col, col], hdim=DUP),
                  HSPMD([g0, g1], [col, col], hdim=0)),
    }


def fig9_graph(a=None):
    """The paper's Fig 9 graph, deduced; its CommOp id=2 is RS + BSR + ID
    in one stage (``repro/runtime/selftest.py:fig9_plan``)."""
    a = a or _api()
    DS, DUP, HSPMD = a.DS, a.DUP, a.HSPMD
    g = a.Graph()
    x_annot = HSPMD(dgs=[[0, 3], [2, 4], [1]],
                    dss=[DS({2: 2}), DS({0: 2}), DS({})], hdim=0)
    w_dup = HSPMD(dgs=[[0, 3], [2, 4], [1]],
                  dss=[DS({DUP: 2}), DS({DUP: 2}), DS({})], hdim=DUP)
    w_tp = HSPMD(dgs=[[0, 3], [2, 4], [1]],
                 dss=[DS({0: 2}), DS({DUP: 2}), DS({})], hdim=DUP)
    x = g.placeholder("X", (12, 16, 32), [x_annot])
    w = g.parameter("W", (32, 64), [w_dup])
    y = g.dot(g.gelu(x), g.comm(w, w_tp), name="Y")
    y_next = HSPMD(dgs=[[0, 3], [5, 6], [1]],
                   dss=[DS({0: 2}), DS({1: 2}), DS({})], hdim=0)
    g.comm(y, y_next, name="Y2")
    g.deduce()
    return g


def hetero_block_strategy(g, a=None):
    """An hsize=2 strategy for a ``models.graph_block.build_block`` graph
    over devices ``[[0, 1], [2, 3]]``, built from the annotation types of
    ``a`` (the port's ``api`` by default, or the JAX package's): every
    activation splits its batch into two equal slabs (``hdim=0``);
    subgroup ``[0, 1]`` runs its slab under dp2 (rows split, weights
    duplicated), subgroup ``[2, 3]`` under tp2 (the slab duplicated, COL
    and ROW weights split, REP ones duplicated); every weight has
    ``hdim=DUP``.  The weight gradients therefore resolve to a bottom AR
    inside ``[0, 1]`` and a top-tier SplitAR, the reference
    ``hetero_program``'s path at block scale (the paper's Fig 17 pattern,
    with a different TP degree in each subgroup)."""
    a = a or _api()
    DS, DUP, HSPMD = a.DS, a.DUP, a.HSPMD
    dgs = [[0, 1], [2, 3]]
    dup = DS({DUP: 2})
    annots = {}
    for t in g.annotation_points():
        role = g.block_roles[t.name]
        if role == "act":
            dss, hdim = [DS({0: 2}), dup], 0
        elif role == "act_last":
            dss, hdim = [DS({0: 2}), DS({len(t.shape) - 1: 2})], 0
        elif role == "col":
            dss, hdim = [dup, DS({1: 2})], DUP
        elif role == "row":
            dss, hdim = [dup, DS({0: 2})], DUP
        elif role == "rep":
            dss, hdim = [dup, dup], DUP
        else:
            raise ValueError(f"unknown block role {role!r} for {t.name}")
        annots[t.name] = HSPMD(dgs, dss, hdim=hdim)
    return a.Strategy("dp2|tp2", annots)


def hsplits_annots(a=None):
    """A non-uniform hsplits source (boxes of 1/4 and 3/4 of dim 0)."""
    a = a or _api()
    src = a.HSPMD(dgs=[[0, 1], [2, 3]], dss=[a.DS({a.DUP: 2}), a.DS({0: 2})],
                  hdim=0, hsplits=[1, 3])
    return src, a.spmd([0, 1, 2, 3], a.DS({0: 4}))


def round_trips(n: int, a=None) -> dict:
    """name -> (src, dst) of the round-trip cases over ``n`` devices."""
    a = a or _api()
    out = {f"split/{n}": (a.spmd(range(n), a.DS({0: n})),
                          a.spmd(range(n), a.DS({1: n})))}
    if n == 4:
        out["hetero/4"] = (a.HSPMD([[0, 1], [2, 3]],
                                   [a.DS({0: 2}), a.DS({0: 2})], hdim=0),
                           a.spmd([0, 1, 2, 3], a.DS({a.DUP: 4})))
    return out


def session_program(n: int, a=None):
    """The ``api:session/n`` pipeline stage: compute and comm interleaved
    over two device halves."""
    a = a or _api()
    half = n // 2
    s0, s1 = list(range(half)), list(range(half, n))
    g = a.Graph()
    g.placeholder("X", (8, 16))
    g.parameter("W1", (16, 12))
    h = g.relu(g.dot(g.tensors["X"], g.tensors["W1"], name="H0"), name="H")
    g.comm(h, name="H2")
    g.parameter("W2", (12, 6))
    g.dot(g.tensors["H2"], g.tensors["W2"], name="Y")
    col = a.DS({1: half}) if half > 1 else a.DS({})
    row = a.DS({0: half}) if half > 1 else a.DS({})
    return a.Program(g, [a.Strategy("pipe", {
        "X": a.spmd(s0, a.DS({a.DUP: half})), "W1": a.spmd(s0, col),
        "H2": a.spmd(s1, row), "W2": a.spmd(s1, a.DS({a.DUP: half}))})])


def session_values(seed: int = 7):
    rng = np.random.default_rng(seed)
    return {"X": rng.integers(-4, 5, (8, 16)).astype(np.float32),
            "W1": rng.integers(-4, 5, (16, 12)).astype(np.float32),
            "W2": rng.integers(-4, 5, (12, 6)).astype(np.float32)}


def switch_graph(n: int, a=None):
    """Two strategies over the two device halves for the switch case:
    W1 column-split then replicated, W2 row-split then replicated."""
    a = a or _api()
    half = n // 2
    s0, s1 = list(range(half)), list(range(half, n))
    g = a.Graph()
    g.placeholder("X", (8, 16, 32),
                  [a.spmd(s0, a.DS({a.DUP: half})),
                   a.spmd(s1, a.DS({0: half}))])
    w1 = g.parameter("W1", (32, 64), [a.spmd(s0, a.DS({1: half})),
                                      a.spmd(s1, a.DS({a.DUP: half}))])
    w2 = g.parameter("W2", (64, 32), [a.spmd(s0, a.DS({0: half})),
                                      a.spmd(s1, a.DS({a.DUP: half}))])
    h = g.dot(g.tensors["X"], w1)
    g.dot(g.gelu(h), w2)
    g.deduce()
    return g


def safe_name(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)


def _world_sum(mesh, values: list[int]) -> list[int]:
    import torch
    import torch.distributed as dist
    dev = mesh.device if mesh.backend == "nccl" else "cpu"
    t = torch.tensor(values, dtype=torch.int64, device=dev)
    dist.all_reduce(t)
    return [int(v) for v in t.tolist()]


class _Saver:
    """Rank 0's writer of one case's arrays."""

    def __init__(self, out_dir, rank):
        self.out_dir = out_dir if rank == 0 else None

    def __call__(self, key: str, arrays: dict) -> None:
        if self.out_dir is None:
            return
        np.savez(os.path.join(self.out_dir, safe_name(key) + ".npz"),
                 **arrays)


def shard_arrays(label: str, st) -> dict:
    """``{label|tensor|dev: shard}`` of a ``{tensor: ShardedTensor}``."""
    return {f"{label}|{name}|{dev}": np.asarray(part)
            for name, s in st.items() for dev, part in s.parts.items()}


def parts_arrays(label: str, parts: dict) -> dict:
    return {f"{label}|x|{dev}": np.asarray(p) for dev, p in parts.items()}


def _same(want, got, what):
    assert set(got.parts) == set(want.parts), what
    for dev, arr in want.parts.items():
        np.testing.assert_array_equal(got.parts[dev], arr,
                                      err_msg=f"{what} dev {dev}")
        assert got.parts[dev].dtype == arr.dtype, (what, dev)


def comm_cases(mesh, n: int, save) -> dict:
    """The comm cases over ``n`` devices: ``key -> fn() -> (extra,
    traffic stats)``."""
    from repro_torch.core.simulator import ShardedTensor, apply_plan, scatter
    from repro_torch.core.specialize import resolve_comm_ops

    from .backend import compile_plan
    from .diff import differential_check, integer_decompose, roundtrip_check
    from .lowering import LoweringStats

    cases = {}
    rng = np.random.default_rng(0)
    value = rng.normal(size=SHAPE).astype(np.float32)
    ivalue = rng.integers(-8, 9, size=SHAPE).astype(np.float32)

    def kind_case(kind, src, dst, fast):
        def case():
            plan, st, real, stats = differential_check(
                ivalue if fast else value, src, dst, mesh,
                reduction="fast" if fast else "exact",
                rng=np.random.default_rng(5),
                decompose=integer_decompose if fast else None)
            kinds = [s.kind for s in plan.steps]
            assert kind in kinds, (kind, kinds, plan.kind)
            save(key, {**parts_arrays("src", st.parts),
                       **parts_arrays("dst", real)})
            return {"plan_kind": plan.kind, "step_kinds": kinds,
                    "tiers": {f: getattr(stats, f) for f in TIERS}}, stats
        key = f"{'int:' if fast else ''}{kind}/{n}"
        return key, case

    for fast in (False, True):
        for kind, (src, dst) in kind_cases(n).items():
            key, fn = kind_case(kind, src, dst, fast)
            cases[key] = fn

    if n >= 4:
        def hsplits_case():
            src, dst = hsplits_annots()
            plan, st, real, stats = differential_check(
                np.random.default_rng(2).normal(size=SHAPE)
                .astype(np.float32), src, dst, mesh)
            save("hetero:hsplits/4", {**parts_arrays("src", st.parts),
                                      **parts_arrays("dst", real)})
            return {"plan_kind": plan.kind}, stats
        cases["hetero:hsplits/4"] = hsplits_case

    if n >= 7:
        def fig9_case():
            rc = resolve_comm_ops(fig9_graph())[1]
            plan, shape = rc.plan, tuple(rc.op.inputs[0].shape)
            v = np.random.default_rng(1).normal(size=shape).astype(
                np.float32)
            st = scatter(v, plan.src)
            compiled = compile_plan(plan, shape, mesh)
            real = compiled(st.parts)
            _same(apply_plan(st, plan),
                  ShardedTensor(shape, plan.dst, real), "fig9")
            save("hetero:fig9/7", {**parts_arrays("src", st.parts),
                                   **parts_arrays("dst", real)})
            return ({"plan_kind": plan.kind,
                     "step_kinds": [s.kind for s in plan.steps]},
                    compiled.stats)
        cases["hetero:fig9/7"] = fig9_case

    if n >= 4:
        def grouped_case():
            # the reference's grouped:reduce/4: a SplitAR over 4 devices
            # whose cross-subgroup reduce groups all run on subgroup
            # collectives
            src, dst = kind_cases(4)["SplitAR"]
            plan, st, real, stats = differential_check(
                value, src, dst, mesh, rng=np.random.default_rng(5))
            assert stats.reduce_groups > 0, vars(stats)
            assert stats.grouped_reduces == stats.reduce_groups, vars(stats)
            save("grouped:reduce/4", {**parts_arrays("src", st.parts),
                                      **parts_arrays("dst", real)})
            return {"reduce_groups": stats.reduce_groups,
                    "grouped": stats.grouped_reduces}, stats
        cases["grouped:reduce/4"] = grouped_case

        def fusion_case():
            # the full-mesh AG is one uniform gather stage: one world
            # all_gather on each rank, no rounds ...
            src, dst = kind_cases(n)["AG"]
            _, _, real, uni = differential_check(value, src, dst, mesh)
            assert uni.uniform_copy_stages == uni.stages > 0, vars(uni)
            assert uni.permute_rounds == 0 and uni.p2p_messages == 0, \
                vars(uni)
            assert uni.collectives == 1, vars(uni)
            for dev in range(n):
                np.testing.assert_array_equal(real[dev], value)
            # ... while an AG over half the world takes the general path,
            # its pairs fused into fewer rounds
            src, dst = kind_cases(n // 2)["AG"]
            _, st, real, stats = differential_check(value, src, dst, mesh)
            assert stats.uniform_copy_stages == 0, vars(stats)
            assert 0 < stats.permute_rounds < stats.copy_pairs, vars(stats)
            for dev in range(n // 2):
                np.testing.assert_array_equal(real[dev], value)
            save(f"fusion:stats/{n}", {**parts_arrays("src", st.parts),
                                       **parts_arrays("dst", real)})
            both = LoweringStats()
            both.merge(uni)
            both.merge(stats)
            return {"copy_pairs": stats.copy_pairs,
                    "permute_rounds": stats.permute_rounds,
                    "uniform_copy_stages": uni.uniform_copy_stages}, both
        cases[f"fusion:stats/{n}"] = fusion_case

    for name, (src, dst) in round_trips(n).items():
        def rt_case(name=name, src=src, dst=dst):
            v = np.random.default_rng(3).normal(size=SHAPE).astype(
                np.float32)
            st, mid, out = roundtrip_check(v, src, dst, mesh)
            save(f"roundtrip:{name}", {**parts_arrays("src", st),
                                       **parts_arrays("mid", mid),
                                       **parts_arrays("out", out)})
            return {}, None
        cases[f"roundtrip:{name}"] = rt_case
    return cases


def grad_plan_kinds(tplan, resolve) -> dict:
    """``{parameter: (hsize, hdim, plan kind)}`` of a compiled train
    plan's gradient reduces: each gradient carrier's source annotation and
    the kind of the plan that ``resolve`` (the port's
    ``core.comm_resolve.resolve``, or the JAX package's) gives it."""
    gg = tplan.graph
    out = {}
    for p in (t.name for t in gg.parameters()):
        carrier = gg.tensors[gg.grad_map[p]]
        src = carrier.producer.inputs[0].annots[0]
        plan = resolve(src, carrier.annots[0], tuple(carrier.shape))
        out[p] = (src.hsize, src.hdim, plan.kind)
    return out


def api_cases(mesh, n: int, save) -> dict:
    """The ``api:*``, switch and elastic cases over ``n`` devices."""
    api = _api()
    from repro_torch.api import testing

    from .lowering import LoweringStats

    made = []      # this case's DistExecutors, for its traffic

    def executors():
        ex = api.DistExecutor(mesh)
        made.append(ex)
        return (("sim", api.SimulatorExecutor()), ("dist", ex))

    def traffic() -> LoweringStats:
        total = LoweringStats()
        while made:
            total.merge(made.pop().traffic())
        return total

    def session_case():
        vals = session_values()
        want = np.maximum(vals["X"] @ vals["W1"], 0) @ vals["W2"]
        outs = {}
        for name, ex in executors():
            sess = api.Session(session_program(n), "pipe", executor=ex)
            sess.load({"W1": vals["W1"], "W2": vals["W2"]})
            res = sess.run({"X": vals["X"]})
            np.testing.assert_array_equal(res.value("Y"), want)
            outs[name] = res.shards("Y")
        _same(outs["sim"], outs["dist"], "Y")
        save(f"api:session/{n}", {**{f"in|{k}|0": v for k, v in
                                      vals.items()},
                                   **shard_arrays("run", {"Y": outs["dist"]})})
        return {}, traffic()

    def pipeline_case(program, values, runs, key, label):
        xv, ws, want_y = values
        got = {}
        for name, ex in executors():
            sess = api.Session(program(), label, executor=ex)
            sess.load(ws)
            for m, kind in runs:
                r = sess.run({"X": xv}, fetches=["Y", "L"],
                             num_microbatches=m, schedule=kind)
                np.testing.assert_array_equal(r.value("Y"), want_y)
                assert float(r.value("L")) == float(want_y.sum())
                got[(name, m, kind)] = r
        arrays = {"in|X|0": xv, **{f"in|{k}|0": v for k, v in ws.items()}}
        for m, kind in runs:
            for t in ("Y", "L"):
                _same(got[("sim", m, kind)].shards(t),
                      got[("dist", m, kind)].shards(t), f"{t} m={m} {kind}")
            arrays.update(shard_arrays(
                f"m{m}-{kind}", {t: got[("dist", m, kind)].shards(t)
                                 for t in ("Y", "L")}))
        save(key, arrays)
        return {"runs": len(runs)}, traffic()

    def train_case():
        xv, ws, want_y = testing.loss_pipeline_values(seed=11)
        runs = {}
        for m, kind in TRAIN_RUNS:
            for name, ex in executors():
                sess = api.Session(
                    testing.loss_pipeline_program(n, name="pipe"), "pipe",
                    executor=ex)
                sess.load(ws)
                r = sess.train_step({"X": xv}, num_microbatches=m,
                                    schedule=kind)
                assert r.loss == float(want_y.sum()), (name, m, kind, r.loss)
                runs[(name, m, kind)] = (r, dict(sess.weights))
        arrays = {"in|X|0": xv, **{f"in|{k}|0": v for k, v in ws.items()}}
        for m, kind in TRAIN_RUNS:
            (rs, ws_), (rd, wd) = runs[("sim", m, kind)], \
                runs[("dist", m, kind)]
            for w in ws:
                _same(rs.grads[w], rd.grads[w], f"grad {w} m={m} {kind}")
                _same(ws_[w], wd[w], f"weight {w} m={m} {kind}")
            arrays.update(shard_arrays(f"m{m}-{kind}-grad", rd.grads))
            arrays.update(shard_arrays(f"m{m}-{kind}-weight", wd))
            arrays[f"m{m}-{kind}-loss|L|0"] = np.float64(rd.loss)
        save(f"api:train/{n}", arrays)
        return {"loss": float(want_y.sum())}, traffic()

    def train_interleaved_case():
        # the zigzag (v=2) program trained under the interleaved schedule:
        # gradients bitwise the simulator's, and equal across m
        xv, ws, want_y = testing.zigzag_values(seed=13)
        runs = {}
        for m in (1, 2, 4):
            for name, ex in executors():
                sess = api.Session(testing.zigzag_program(n, name="zig"),
                                   "zig", executor=ex)
                sess.load(ws)
                r = sess.train_step({"X": xv}, num_microbatches=m,
                                    schedule="interleaved")
                assert r.loss == float(want_y.sum()), (name, m, r.loss)
                runs[(name, m)] = (r, dict(sess.weights))
        base = runs[("sim", 1)][0]
        arrays = {"in|X|0": xv, **{f"in|{k}|0": v for k, v in ws.items()}}
        for (name, m), (r, w) in runs.items():
            for k in ws:
                _same(base.grads[k], r.grads[k], f"grad {k} {name} m={m}")
            if name == "dist":
                for k in ws:
                    _same(runs[("sim", m)][1][k], w[k], f"weight {k} m={m}")
                arrays.update(shard_arrays(f"m{m}-grad", r.grads))
                arrays.update(shard_arrays(f"m{m}-weight", w))
                arrays[f"m{m}-loss|L|0"] = np.float64(r.loss)
        save(f"api:train/interleaved{n}", arrays)
        return {"loss": base.loss}, traffic()

    def train_hetero_case():
        # hsize=2 training: the weight gradients come out hdim=Partial
        # (one summand a subgroup's batch slab, another bottom-tier
        # Partial inside the row-split subgroup), so each gradient's
        # reduce is a bottom AR and then a top SplitAR
        from repro_torch.core.annotations import PARTIAL
        from repro_torch.core.comm_resolve import resolve

        prog = testing.hetero_program()
        xv, ws, want_loss, want_grads = testing.hetero_values(seed=7)
        kinds = grad_plan_kinds(prog.compile_train("het", loss="L"),
                                resolve)
        for w, (hsize, hdim, kind) in kinds.items():
            assert hsize == 2 and hdim == PARTIAL, (w, hsize, hdim)
            assert "SplitAR" in kind, (w, kind)
        runs = {}
        for m in (1, 2):
            for name, ex in executors():
                sess = api.Session(prog, "het", executor=ex)
                sess.load(ws)
                r = sess.train_step({"X": xv}, num_microbatches=m)
                assert r.loss == want_loss, (name, m, r.loss)
                runs[(name, m)] = r
        base = runs[("sim", 1)]
        for k, want in want_grads.items():
            for dev, part in base.grads[k].parts.items():
                np.testing.assert_array_equal(
                    part, want.astype(np.float32),
                    err_msg=f"hetero grad {k} dev {dev} vs the dense one")
        arrays = {"in|X|0": xv, **{f"in|{k}|0": v for k, v in ws.items()}}
        for (name, m), r in runs.items():
            for k in ws:
                _same(base.grads[k], r.grads[k], f"grad {k} {name} m={m}")
            if name == "dist":
                arrays.update(shard_arrays(f"m{m}-grad", r.grads))
        save("api:train/hetero4", arrays)
        return {"loss": want_loss,
                "grad_comms": {w: k[2] for w, k in kinds.items()}}, \
            traffic()

    def elastic_case(key):
        # a trace through device loss and join on the ranks: weights, m
        # and v bitwise the uninterrupted run's (the probe's gradients
        # are weight-independent integers), losses to rtol 1e-5
        from repro_torch.core.simulator import gather
        from repro_torch.elastic import ElasticDriver, TraceEvent
        from repro_torch.elastic.fixtures import (probe_feeds, probe_graph,
                                                  probe_layout,
                                                  probe_provider,
                                                  probe_values,
                                                  reference_run)

        def snap(sess):
            out = {k: gather(st) for k, st in sess.weights.items()}
            for part in ("m", "v"):
                for k, st in sess.opt_state[part].items():
                    out[f"{part}/{k}"] = gather(st)
            return out

        trace, want_kinds = ELASTIC_TRACES[key]
        ref, ref_losses = reference_run(
            probe_layout([0, 1, 2, 3], "dp"), ELASTIC_STEPS,
            executor=api.SimulatorExecutor())
        want = snap(ref)
        ex = api.DistExecutor(mesh)
        made.append(ex)
        drv = ElasticDriver(probe_graph(), probe_values(), probe_provider(),
                            probe_feeds, executor=ex, num_microbatches=2)
        run = drv.run([TraceEvent(*e) for e in trace], ELASTIC_STEPS)
        got = snap(drv.session)
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k, v in want.items():
            np.testing.assert_array_equal(
                got[k], v, err_msg=f"{k} drifted from the uninterrupted run")
        np.testing.assert_allclose(run.losses, ref_losses, rtol=1e-5)
        assert len(run.transitions) == 2, run.summary()
        assert run.transition_kinds() == want_kinds, run.transition_kinds()
        save(key, {f"final|{k.replace('/', ':')}|0": v
                   for k, v in got.items()}
             | {"losses|L|0": np.asarray(run.losses, np.float64)})
        return {"kinds": run.transition_kinds(),
                "losses": [float(x) for x in run.losses]}, traffic()

    def switch_case():
        from repro_torch.core.simulator import scatter
        from repro_torch.core.switching import execute_switch

        g = switch_graph(n)
        srng = np.random.default_rng(3)
        values = {p.name: srng.normal(size=p.shape).astype(np.float32)
                  for p in g.parameters()}
        weights = {name: scatter(v, g.tensors[name].annots[0])
                   for name, v in values.items()}
        real = execute_switch(weights, g, 0, 1, backend="dist", mesh=mesh)
        sim = execute_switch(weights, g, 0, 1, backend="sim")
        for name in values:
            _same(sim[name], real[name], f"switch {name}")
        back = execute_switch(real, g, 1, 0, backend="dist", mesh=mesh)
        for name in values:
            _same(weights[name], back[name], f"switch back {name}")
        save(f"switch:dist/{n}", {**shard_arrays("src", weights),
                                   **shard_arrays("dst", real),
                                   **shard_arrays("back", back)})
        return {}, None

    cases = {
        f"api:session/{n}": session_case,
        f"api:pipeline/{n}": lambda: pipeline_case(
            lambda: testing.loss_pipeline_program(n, name="pipe"),
            testing.loss_pipeline_values(seed=11), PIPE_RUNS,
            f"api:pipeline/{n}", "pipe"),
        f"api:pipeline/interleaved{n}": lambda: pipeline_case(
            lambda: testing.zigzag_program(n, name="zig"),
            testing.zigzag_values(seed=13),
            [(m, "interleaved") for m in (1, 2, 4)],
            f"api:pipeline/interleaved{n}", "zig"),
        f"api:train/{n}": train_case,
        f"api:train/interleaved{n}": train_interleaved_case,
        f"switch:dist/{n}": switch_case,
    }
    if n >= 4:
        cases["api:train/hetero4"] = train_hetero_case
        for key in ELASTIC_TRACES:
            cases[key] = lambda key=key: elastic_case(key)
    return cases


def async_cases(mesh, n: int, save) -> dict:
    """The ``async:*`` cases over ``n`` devices."""
    import torch.distributed as dist

    api = _api()
    from repro_torch.api import testing

    from .lowering import LoweringStats

    made = []      # this case's DistAsyncExecutors, for its traffic

    def dist_async(**kw):
        ex = api.DistAsyncExecutor(mesh, **kw)
        made.append(ex)
        return ex

    def traffic() -> LoweringStats:
        total = LoweringStats()
        while made:
            total.merge(made.pop().traffic())
        return total

    def pipeline_case():
        prog = testing.loss_pipeline_program(n, name=f"pipe{n}")
        xv, ws, want_y = testing.loss_pipeline_values(seed=11)
        executors = {"sim": api.SimulatorExecutor(),
                     "dist": api.DistExecutor(mesh),
                     "dist-async": dist_async(),
                     "dist-async/serialized": dist_async(serialize=True)}
        runs = {}
        for label, ex in executors.items():
            sess = api.Session(prog, f"pipe{n}", executor=ex)
            sess.load(ws)
            for m, kind in ASYNC_PIPE_RUNS:
                r = sess.run({"X": xv}, fetches=["Y", "L"],
                             num_microbatches=m, schedule=kind)
                np.testing.assert_array_equal(r.value("Y"), want_y)
                assert float(r.value("L")) == float(want_y.sum())
                runs[(label, m, kind)] = r
        # per-device shards bitwise across executors at each (m, kind):
        # L is Partial, so its summands compare at the same microbatching
        arrays = {"in|X|0": xv, **{f"in|{k}|0": v for k, v in ws.items()}}
        for m, kind in ASYNC_PIPE_RUNS:
            for label in ("dist", "dist-async", "dist-async/serialized"):
                for t in ("Y", "L"):
                    _same(runs[("sim", m, kind)].shards(t),
                          runs[(label, m, kind)].shards(t),
                          f"{t} {label} m={m} {kind}")
            arrays.update(shard_arrays(
                f"m{m}-{kind}", {t: runs[("dist-async", m, kind)].shards(t)
                                 for t in ("Y", "L")}))
        save(f"async:pipeline/{n}", arrays)
        # per-stage MPMD: over the ranks, one fwd and one bwd program per
        # virtual stage, and the boundary P2P and grad reduces as channels
        lw = executors["dist-async"].lowered(prog.compile_train(f"pipe{n}"))
        keys = [list(k) for k in lw.programs]
        every = [None] * mesh.world
        dist.all_gather_object(every, keys)
        union = {tuple(k) for rank_keys in every for k in rank_keys}
        n_virtual = prog.compile(f"pipe{n}").n_stages
        assert len(union) == 2 * n_virtual, (sorted(union), n_virtual)
        kinds = [ch.kind for ch in lw.channels]
        if n >= 4:      # n=2: 1-device stages -> no partial grads
            assert "reduce" in kinds, kinds
        if n_virtual > 1:
            assert "p2p" in kinds, kinds
        return {"programs": len(union), "channels": len(lw.channels),
                "channel_kinds": sorted(set(kinds)),
                "runs": len(ASYNC_PIPE_RUNS)}, traffic()

    def train_case():
        prog = testing.loss_pipeline_program(4, name="pipe4")
        xv, ws, want_y = testing.loss_pipeline_values(seed=11)
        want_loss = float(want_y.sum())
        runs = {}
        for m, kind in ASYNC_TRAIN_RUNS:
            for label, ex in (("sim", api.SimulatorExecutor()),
                              ("dist-async", dist_async())):
                sess = api.Session(prog, "pipe4", executor=ex)
                sess.load(ws)
                r = sess.train_step({"X": xv}, num_microbatches=m,
                                    schedule=kind)
                assert r.loss == want_loss, (label, m, kind, r.loss)
                runs[(label, m, kind)] = (r, dict(sess.weights))
        base, base_w = runs[("sim", 1, "1f1b")]
        arrays = {"in|X|0": xv, **{f"in|{k}|0": v for k, v in ws.items()}}
        for (label, m, kind), (r, w) in runs.items():
            for k in ws:
                _same(base.grads[k], r.grads[k],
                      f"grad {k} {label} m={m} {kind}")
                _same(base_w[k], w[k], f"weight {k} {label} m={m} {kind}")
            if label == "dist-async":
                arrays.update(shard_arrays(f"m{m}-{kind}-grad", r.grads))
                arrays.update(shard_arrays(f"m{m}-{kind}-weight", w))
                arrays[f"m{m}-{kind}-loss|L|0"] = np.float64(r.loss)
        # the v=2 interleaved zigzag: a device's two chunks on distinct
        # per-chunk programs
        zx, zws, zwant_y = testing.zigzag_values(seed=13)
        zruns = {}
        for m in (1, 2, 4):
            for label, ex in (("sim", api.SimulatorExecutor()),
                              ("dist-async", dist_async())):
                sess = api.Session(testing.zigzag_program(4, name="zig4"),
                                   "zig4", executor=ex)
                sess.load(zws)
                r = sess.train_step({"X": zx}, num_microbatches=m,
                                    schedule="interleaved")
                assert r.loss == float(zwant_y.sum()), (label, m, r.loss)
                zruns[(label, m)] = (r, dict(sess.weights))
        zbase = zruns[("sim", 1)][0]
        arrays.update({f"zin|{k}|0": v for k, v in zws.items()})
        arrays["zin|X|0"] = zx
        for (label, m), (r, w) in zruns.items():
            for k in zws:
                _same(zbase.grads[k], r.grads[k], f"zig grad {k} {label} "
                                                  f"m={m}")
                _same(zruns[("sim", m)][1][k], w[k],
                      f"zig weight {k} {label} m={m}")
            if label == "dist-async":
                arrays.update(shard_arrays(f"zig-m{m}-grad", r.grads))
                arrays.update(shard_arrays(f"zig-m{m}-weight", w))
                arrays[f"zig-m{m}-loss|L|0"] = np.float64(r.loss)
        save("async:train/4", arrays)
        return {"loss": want_loss, "zigzag_loss": zbase.loss}, traffic()

    cases = {f"async:pipeline/{n}": pipeline_case}
    if n == 4:
        cases["async:train/4"] = train_case
    return cases


def search_cases(mesh, n: int, save) -> dict:
    """``search:hetero/4`` (at ``n = 4``)."""

    def search_case():
        from repro_torch.search import Searcher, cpu_hetero_cluster, tiny_spec

        searcher = Searcher(tiny_spec(), global_batch=8, seq_len=128,
                            tp_options=(1, 2), pp_options=(1, 2),
                            pipeline_options=(1, 2), virtual_options=(1,))
        result = searcher.search(cpu_hetero_cluster(2, 2), validate_top=3,
                                 executors=("sim", "dist"), mesh=mesh,
                                 repeats=5, batch=64, d=64, f=128)
        val = result.validation
        assert val is not None and val.speed_projected
        execed = [e for e in val.executed if e.error is None]
        assert len(execed) == 3, [e.describe() for e in val.executed]
        assert all(e.bit_exact for e in execed), \
            [e.describe() for e in execed]
        ag = val.agreement()
        assert ag is not None and ag >= 2 / 3, val.summary()
        best = result.best.candidate
        assert best.kind == "hetero", best.describe()
        # the same report on every rank, to the last bit of every time
        import torch.distributed as dist
        mine = [val.speed_projected, ag] + [
            [e.name, e.m, e.schedule, e.predicted_s, e.measured_wall_s,
             e.measured_makespan_s, e.projected_makespan_s,
             e.proxy_predicted_s, e.loss, e.bit_exact, e.error]
            for e in val.executed]
        every = [None] * mesh.world
        dist.all_gather_object(every, mine)
        assert all(r == mine for r in every), every
        return {"winner": best.name, "agreement": ag,
                "prune": result.prune_report.counts(),
                "executed": mine[2:], "summary": val.summary(),
                "ranks_agree": len(every)}, val.traffic

    return {"search:hetero/4": search_case} if n == 4 else {}


def run_all(mesh, groups=GROUPS, out_dir=None) -> dict:
    """Every case of ``groups`` over the mesh's ranks, in order, up to the
    first that fails on this rank; the same report on every rank while
    the cases pass.  A case's exchanges are collective, so a rank whose
    case failed part way is out of step with the others: the sweep stops
    there rather than feed a later case's collectives the wrong
    partners."""
    n = mesh.world
    save = _Saver(out_dir, mesh.rank)
    cases = {}
    if "comm" in groups:
        cases.update(comm_cases(mesh, n, save))
    if "api" in groups:
        cases.update(api_cases(mesh, n, save))
    if "async" in groups:
        cases.update(async_cases(mesh, n, save))
    if "search" in groups:
        cases.update(search_cases(mesh, n, save))
    report: dict = {"ranks": n, "backend": mesh.backend,
                    "device": str(mesh.device.type), "cases": {}}
    for key, fn in cases.items():
        try:
            extra, stats = fn()
            entry = {"ok": True, **extra}
            if stats is not None:
                entry.update(zip(TRAFFIC, _world_sum(
                    mesh, [getattr(stats, f) for f in TRAFFIC])))
        except Exception as e:  # noqa: BLE001 — reported, sweep stops
            entry = {"ok": False, "error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc(limit=8)}
        report["cases"][key] = entry
        if not entry["ok"]:
            report["failed_rank"] = mesh.rank
            break
    report["ok"] = all(c["ok"] for c in report["cases"].values())
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default=None,
                    help="process-group backend: gloo or nccl")
    ap.add_argument("--device", default=None, help="cpu or cuda")
    ap.add_argument("--cases", default=",".join(GROUPS),
                    help="comma-separated case groups: "
                         + ", ".join(GROUPS))
    ap.add_argument("--out", default=None,
                    help="directory for each case's shards (rank 0)")
    args = ap.parse_args(argv)
    groups = tuple(args.cases.split(","))
    if not set(groups) <= set(GROUPS):
        ap.error(f"unknown case groups {groups}")
    from repro_torch.launch.mesh import make_runtime_mesh
    mesh = make_runtime_mesh(backend=args.backend, device=args.device)
    if args.out and mesh.rank == 0:
        os.makedirs(args.out, exist_ok=True)
    report = run_all(mesh, groups, args.out)
    if mesh.rank == 0 or not report["ok"]:
        for key, c in report["cases"].items():
            status = "ok" if c["ok"] else f"FAIL: {c.get('error')}"
            print(f"  {key:28s} {status}")
        print("RUNTIME_SELFTEST_JSON " + json.dumps(report), flush=True)
    # the process group is destroyed at exit (launch.mesh), within a
    # time limit: after a failed case a peer may still be in an exchange
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
