"""``TorchExecutor`` on the CPU against the JAX package's simulator.

Every virtual device is one row of stacked buffers on one torch device, so
2, 4 and 8 virtual devices run here.  Each case builds its program through
both ``repro.api`` and ``repro_torch.api`` and runs it on three executors:
the JAX package's ``SimulatorExecutor`` (``repro.core.simulator``, numpy:
the reference), the port's copy of it, and ``TorchExecutor``.  Every
comparison is bit for bit, shard by shard, on exactly representable data
(integer-valued float32 through dot, add, relu, sums and all comm):

* every CommStep kind on 2, 4 and 8 devices, on random normal shards (the
  float64 fold in ``srcs`` order) and on integer-valued shards, through a
  one-comm program,
* the paper's Fig 9 multi-step stage, hsplits, and round trips, through
  the comm lowering (``runtime.lowering.execute_plan``) against the JAX
  package's ``simulator.apply_plan``,
* the ``api:session``, ``api:pipeline`` and ``api:train`` cases of the
  reference's runtime selftest (``repro/runtime/selftest.py``), and the
  hetero training fixture.

The selftest's tables (``kind_cases``, ``fig9_plan``) are copied here, not
imported: importing ``repro.runtime.selftest`` parses argv and sets
``XLA_FLAGS``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from repro import api as japi
from repro.api import testing as jtesting
from repro.core.simulator import apply_plan as japply_plan
from repro.core.specialize import resolve_comm_ops as jresolve_comm_ops
from repro_torch import api
from repro_torch.api import testing as ttesting
from repro_torch.core.annotations import DS, DUP, spmd
from repro_torch.core.simulator import apply_plan, scatter
from repro_torch.core.specialize import resolve_comm_ops
from repro_torch.runtime.lowering import execute_plan

JAX = SimpleNamespace(api=japi, testing=jtesting, apply_plan=japply_plan,
                      resolve_comm_ops=jresolve_comm_ops)
PORT = SimpleNamespace(api=api, testing=ttesting, apply_plan=apply_plan,
                       resolve_comm_ops=resolve_comm_ops)

SHAPE = (16, 8)
KINDS = ("ID", "SR", "AR", "RS", "AG", "SplitAR", "SplitRS", "SplitAG",
         "BSR", "Slice")
NS = (2, 4, 8)


def kind_cases(n: int, a=api) -> dict:
    """(src, dst) pairs over n devices resolving to each operator kind
    (copied from ``repro/runtime/selftest.py:kind_cases``), built from
    the annotation types of ``a`` (either package's ``api``)."""
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


def fig9_plan(pkg=PORT):
    """The paper's Fig 9 CommOp id=2: RS + BSR + ID in one stage (copied
    from ``repro/runtime/selftest.py:fig9_plan``), planned by ``pkg``."""
    a = pkg.api
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
    x2 = g.gelu(x)
    w2 = g.comm(w, w_tp)
    y = g.dot(x2, w2, name="Y")
    y_next = HSPMD(dgs=[[0, 3], [5, 6], [1]],
                   dss=[DS({0: 2}), DS({1: 2}), DS({})], hdim=0)
    g.comm(y, y_next, name="Y2")
    g.deduce()
    rc = pkg.resolve_comm_ops(g)[1]
    return rc.plan, tuple(rc.op.inputs[0].shape)


def integer_decompose(value, k, rng):
    """Summands over small integers (``repro/runtime/diff.py``): float32
    sums of these are exact in any order."""
    if k == 1:
        return [value]
    pieces = [rng.integers(-8, 9, size=value.shape).astype(value.dtype)
              for _ in range(k - 1)]
    pieces.append(value - sum(pieces))
    return pieces


def torch_ex():
    return api.TorchExecutor(device="cpu")


def executors():
    """``(name, package, executor)``: the JAX package's simulator (the
    reference, ``"ref"``), the port's copy of it and ``TorchExecutor``."""
    return [("ref", JAX, japi.SimulatorExecutor()),
            ("sim", PORT, api.SimulatorExecutor()),
            ("torch", PORT, torch_ex())]


def assert_shards_equal(want, got, what=""):
    assert set(got.parts) == set(want.parts), what
    for dev, arr in want.parts.items():
        np.testing.assert_array_equal(got.parts[dev], arr,
                                      err_msg=f"{what} dev {dev}")
        assert got.parts[dev].dtype == arr.dtype, (what, dev)


def assert_all_equal(outs, what=""):
    """The port's simulator and ``TorchExecutor`` against the reference."""
    for name in ("sim", "torch"):
        assert_shards_equal(outs["ref"], outs[name], f"{what} {name}")


def run_comm(kind, n, parts):
    """One comm op ``X -> Y`` of ``kind`` on every executor; ``parts``
    are X's shards under the kind's source annotation."""
    outs = {}
    for name, pkg, ex in executors():
        src, dst = kind_cases(n, pkg.api)[kind]
        g = pkg.api.Graph()
        g.placeholder("X", SHAPE)
        g.comm(g.tensors["X"], name="Y")
        prog = pkg.api.Program(g, [pkg.api.Strategy("s", {"X": src,
                                                          "Y": dst})])
        st = pkg.api.ShardedTensor(SHAPE, src, dict(parts))
        outs[name] = pkg.api.Session(prog, "s", executor=ex).run(
            {"X": st}).shards("Y")
        if name == "ref":
            assert kind in [s.kind for s in
                            pkg.api.resolve(src, dst, SHAPE).steps]
            plan = prog.compile("s").specialization.resolved[0].plan
            assert_shards_equal(pkg.apply_plan(st, plan), outs["ref"])
    return outs


# -- every CommStep kind, through every executor ---------------------------

@pytest.mark.parametrize("shards", ["exact", "integer"])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", KINDS)
def test_commstep_kind_matches_simulator(kind, n, shards):
    """``shards="exact"``: random normal summands, which only a float64
    fold in ``srcs`` order reproduces; ``"integer"``: integer-valued
    summands, whose sums are exact in any order."""
    src, _ = kind_cases(n)[kind]
    rng = np.random.default_rng(0)
    if shards == "exact":
        value = rng.normal(size=SHAPE).astype(np.float32)
        st = scatter(value, src, rng=rng)
    else:
        value = rng.integers(-8, 9, size=SHAPE).astype(np.float32)
        st = scatter(value, src, rng=rng, decompose=integer_decompose)
    assert_all_equal(run_comm(kind, n, st.parts), f"{kind}/{n}")


def cancelling_decompose(value, k, rng):
    """Per element, summands 1e17, -1e17 and small values, in a random
    order: a small value added to 1e17 before the big pair cancels is
    lost, so the float64 sum depends on the order it is taken in, and
    only a fold in the group's ``srcs`` order reproduces the simulator."""
    big = np.full(value.shape, 1e17, value.dtype)
    pieces = np.stack([big, -big] + [rng.normal(size=value.shape)
                                    .astype(value.dtype)
                                    for _ in range(k - 2)])
    return list(rng.permuted(pieces, axis=0))


@pytest.mark.parametrize("n", (4, 8))
@pytest.mark.parametrize("kind", ("AR", "RS", "SplitAR", "SplitRS"))
def test_exact_reduction_folds_in_srcs_order(kind, n):
    src, _ = kind_cases(n)[kind]
    rng = np.random.default_rng(5)
    st = scatter(np.zeros(SHAPE, np.float32), src, rng=rng,
                 decompose=cancelling_decompose)
    assert_all_equal(run_comm(kind, n, st.parts), f"{kind}/{n}")


# -- heterogeneous stages and round trips, through the comm lowering --------

def reference_apply(plan_of, parts, shape, what):
    """The JAX package's ``apply_plan`` of its own plan, and the port's
    copy of it, on the same shards; returns the reference's."""
    outs = {}
    for name, pkg in (("ref", JAX), ("sim", PORT)):
        plan = plan_of(pkg)
        outs[name] = pkg.apply_plan(
            pkg.api.ShardedTensor(shape, plan.src, dict(parts)), plan)
    assert_shards_equal(outs["ref"], outs["sim"], f"{what} sim")
    return outs["ref"]


def test_fig9_multi_step_stage_matches_simulator():
    plan, shape = fig9_plan()
    value = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    st = scatter(value, plan.src)
    got = execute_plan(plan, st.parts, shape, "cpu")
    want = reference_apply(lambda pkg: fig9_plan(pkg)[0], st.parts, shape,
                           "fig9")
    assert_shards_equal(want, api.ShardedTensor(shape, plan.dst, got),
                        "fig9")


def hsplits_annots(a):
    src = a.HSPMD(dgs=[[0, 1], [2, 3]], dss=[a.DS({a.DUP: 2}), a.DS({0: 2})],
                  hdim=0, hsplits=[1, 3])
    return src, a.spmd([0, 1, 2, 3], a.DS({0: 4}))


def test_hsplits_stage_matches_simulator():
    src, dst = hsplits_annots(api)
    value = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
    st = scatter(value, src)
    got = execute_plan(api.resolve(src, dst, SHAPE), st.parts, SHAPE, "cpu")
    want = reference_apply(
        lambda pkg: pkg.api.resolve(*hsplits_annots(pkg.api), SHAPE),
        st.parts, SHAPE, "hsplits")
    assert_shards_equal(want, api.ShardedTensor(SHAPE, dst, got), "hsplits")


def _split(n):
    return lambda a: (a.spmd(range(n), a.DS({0: n})),
                      a.spmd(range(n), a.DS({1: n})))


ROUND_TRIPS = [(f"split/{n}", _split(n)) for n in NS] + [
    ("hetero/4", lambda a: (a.HSPMD([[0, 1], [2, 3]],
                                    [a.DS({0: 2}), a.DS({0: 2})], hdim=0),
                            a.spmd([0, 1, 2, 3], a.DS({a.DUP: 4}))))]


@pytest.mark.parametrize("name,annots", ROUND_TRIPS,
                         ids=[r[0] for r in ROUND_TRIPS])
def test_round_trip_restores_the_shards(name, annots):
    src, dst = annots(api)
    value = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
    st = scatter(value, src)
    there, back = api.resolve(src, dst, SHAPE), api.resolve(dst, src, SHAPE)
    mid = execute_plan(there, st.parts, SHAPE, "cpu")
    want = reference_apply(lambda pkg: pkg.api.resolve(
        *annots(pkg.api), SHAPE), st.parts, SHAPE, name)
    assert_shards_equal(want, api.ShardedTensor(SHAPE, dst, mid), name)
    out = execute_plan(back, mid, SHAPE, "cpu")
    assert_shards_equal(st, api.ShardedTensor(SHAPE, src, out), name)


# -- api:session, api:pipeline, api:train ----------------------------------

def session_program(n, a=api):
    """The ``api:session/{n}`` pipeline stage: compute and comm
    interleaved over two device halves, built through ``a``."""
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


@pytest.mark.parametrize("n", NS)
def test_session_run_matches_simulator(n):
    rng = np.random.default_rng(7)
    xv = rng.integers(-4, 5, (8, 16)).astype(np.float32)
    w1 = rng.integers(-4, 5, (16, 12)).astype(np.float32)
    w2 = rng.integers(-4, 5, (12, 6)).astype(np.float32)
    outs = {}
    for name, pkg, ex in executors():
        sess = pkg.api.Session(session_program(n, pkg.api), "pipe",
                               executor=ex)
        sess.load({"W1": w1, "W2": w2})
        res = sess.run({"X": xv})
        np.testing.assert_array_equal(res.value("Y"),
                                      np.maximum(xv @ w1, 0) @ w2)
        outs[name] = res.shards("Y")
    assert_all_equal(outs, f"session/{n}")


PIPE_RUNS = [(1, "1f1b"), (2, "1f1b"), (4, "1f1b"), (4, "gpipe"),
             (1, "interleaved"), (2, "interleaved"), (4, "interleaved")]


@pytest.mark.parametrize("n", NS)
def test_pipeline_runs_match_simulator(n):
    """``api:pipeline/{n}``: per-microbatch outputs combined by role, bit
    for bit against the simulator's timetable, for every m and kind."""
    xv, ws, want_y = ttesting.loss_pipeline_values(seed=11)
    runs = {}
    for ex_name, pkg, ex in executors():
        prog = pkg.testing.loss_pipeline_program(n, name="pipe")
        sess = pkg.api.Session(prog, "pipe", executor=ex)
        sess.load(ws)
        for m, kind in PIPE_RUNS:
            r = sess.run({"X": xv}, fetches=["Y", "L"], num_microbatches=m,
                         schedule=kind)
            np.testing.assert_array_equal(r.value("Y"), want_y)
            assert float(r.value("L")) == float(want_y.sum())
            runs[(ex_name, m, kind)] = r
    for m, kind in PIPE_RUNS:
        for name in ("Y", "L"):
            assert_all_equal({e: runs[(e, m, kind)].shards(name)
                              for e in ("ref", "sim", "torch")},
                             f"{name} m={m} {kind}")


@pytest.mark.parametrize("n", NS)
def test_interleaved_pipeline_runs_match_simulator(n):
    """``api:pipeline/interleaved{n}``: the zigzag (v=2) plan."""
    xv, ws, want_y = ttesting.zigzag_values(seed=13)
    runs = {}
    for ex_name, pkg, ex in executors():
        prog = pkg.testing.zigzag_program(n, name="zig")
        sess = pkg.api.Session(prog, "zig", executor=ex)
        sess.load(ws)
        for m in (1, 2, 4):
            r = sess.run({"X": xv}, fetches=["Y", "L"], num_microbatches=m,
                         schedule="interleaved")
            np.testing.assert_array_equal(r.value("Y"), want_y)
            runs[(ex_name, m)] = r
        with pytest.raises(pkg.api.ScheduleError):
            sess.run({"X": xv}, num_microbatches=2, schedule="1f1b")
    for m in (1, 2, 4):
        for name in ("Y", "L"):
            assert_all_equal({e: runs[(e, m)].shards(name)
                              for e in ("ref", "sim", "torch")},
                             f"{name} m={m}")


TRAIN_RUNS = [(1, "1f1b"), (2, "1f1b"), (4, "1f1b"), (4, "gpipe")]


def _train_runs(build, strat, xv, ws, runs_spec):
    """``(executor name, m, kind) -> (TrainResult, weights after)``, the
    program built by ``build(pkg)`` for each executor's package."""
    runs = {}
    for m, kind in runs_spec:
        for name, pkg, ex in executors():
            sess = pkg.api.Session(build(pkg), strat, executor=ex)
            sess.load(ws)
            r = sess.train_step({"X": xv}, num_microbatches=m,
                                schedule=kind)
            runs[(name, m, kind)] = (r, dict(sess.weights))
    return runs


@pytest.mark.parametrize("n", NS)
def test_train_steps_match_simulator(n):
    """``api:train/{n}``: loss, gradient shards and updated weight shards
    bit for bit against the reference simulator, across m and
    schedules."""
    xv, ws, want_y = ttesting.loss_pipeline_values(seed=11)
    runs = _train_runs(
        lambda pkg: pkg.testing.loss_pipeline_program(n, name="pipe"),
        "pipe", xv, ws, TRAIN_RUNS)
    base, base_w = runs[("ref", 1, "1f1b")]
    for key, (r, w) in runs.items():
        assert r.loss == float(want_y.sum()), key
        for name in ws:
            assert_shards_equal(base.grads[name], r.grads[name],
                                f"grad {name} {key}")
            assert_shards_equal(base_w[name], w[name], f"weight {name} {key}")


@pytest.mark.parametrize("n", NS)
def test_interleaved_train_steps_match_simulator(n):
    """``api:train/interleaved{n}``: the zigzag plan's backward drains
    chunk 1 before chunk 0."""
    xv, ws, want_y = ttesting.zigzag_values(seed=13)
    runs = _train_runs(
        lambda pkg: pkg.testing.zigzag_program(n, name="zig"), "zig", xv,
        ws, [(m, "interleaved") for m in (1, 2, 4)])
    base, _ = runs[("ref", 1, "interleaved")]
    for key, (r, _) in runs.items():
        assert r.loss == float(want_y.sum()), key
        for name in ws:
            assert_shards_equal(base.grads[name], r.grads[name],
                                f"grad {name} {key}")


def test_hetero_train_steps_match_simulator():
    """``api:train/hetero4``: uneven shards and more than one class; the
    grad-reduce runs a bottom AR then a top-tier SplitAR."""
    xv, ws, want_loss, want_grads = ttesting.hetero_values(seed=7)
    runs = _train_runs(lambda pkg: pkg.testing.hetero_program(), "het", xv,
                       ws, [(1, "1f1b"), (2, "1f1b")])
    base, _ = runs[("ref", 1, "1f1b")]
    for name, want in want_grads.items():
        for part in base.grads[name].parts.values():
            np.testing.assert_array_equal(part, want.astype(np.float32))
    for key, (r, _) in runs.items():
        assert r.loss == want_loss, key
        for name in ws:
            assert_shards_equal(base.grads[name], r.grads[name],
                                f"grad {name} {key}")
    tplan = ttesting.hetero_program().compile_train("het")
    ir = torch_ex().lowered(tplan, [tplan.loss_name]).ir
    assert max(ir.class_counts()) > 1    # the hetero plan has classes


def test_get_executor_knows_sim_and_torch():
    assert isinstance(api.get_executor("sim"), api.SimulatorExecutor)
    ex = api.get_executor("torch", device="cpu")
    assert isinstance(ex, api.TorchExecutor) and ex.name == "torch"
    assert isinstance(ex, api.Executor)
    with pytest.raises(ValueError, match="sim, torch"):
        api.get_executor("jax")
    with pytest.raises(TypeError):
        api.get_executor("torch", mesh=None)


def test_session_switch_migrates_through_the_simulator():
    """``Session.switch`` migrates on the session's executor: a
    ``SimulatorExecutor`` session through the numpy simulator, a
    ``TorchExecutor`` session through the torch comm lowering on its
    device; both bitwise the JAX package's simulator switch.  The core
    switch's ``"jax"`` backend raises and names ``"torch"``."""
    from repro.core.switching import execute_switch as jexecute_switch
    from repro_torch.core.switching import execute_switch

    def program(pkg):
        sp, ds, dup = pkg.spmd, pkg.DS, pkg.DUP
        g = pkg.Graph()
        g.placeholder("X", (8, 16), [sp([0, 1], ds({dup: 2})),
                                     sp([0, 1], ds({0: 2}))])
        g.parameter("W", (16, 8), [sp([0, 1], ds({1: 2})),
                                   sp([0, 1], ds({dup: 2}))])
        g.dot(g.tensors["X"], g.tensors["W"], name="Y")
        return pkg.Program(g, [pkg.Strategy("tp", {
            "X": sp([0, 1], ds({dup: 2})), "W": sp([0, 1], ds({1: 2}))}),
            pkg.Strategy("dp", {"X": sp([0, 1], ds({0: 2})),
                                "W": sp([0, 1], ds({dup: 2}))})])

    w = np.arange(128, dtype=np.float32).reshape(16, 8)
    xv = np.ones((8, 16), np.float32)
    jprog = program(japi)
    jsess = japi.Session(jprog, "tp")
    jsess.load({"W": w})
    want = jexecute_switch(jsess.weights, jprog.graph, 0, 1)["W"]
    for ex, moved in ((api.SimulatorExecutor(), False), (torch_ex(), True)):
        prog = program(api)
        sess = api.Session(prog, "tp", executor=ex)
        sess.load({"W": w})
        before = sess.run({"X": xv}).value("Y")
        report = sess.switch("dp")
        assert report.dst_name == "dp"
        assert ("move" in report.execute_seconds) == moved, ex.name
        assert sess.weights["W"].parts.keys() == want.parts.keys()
        for dev, part in want.parts.items():
            np.testing.assert_array_equal(sess.weights["W"].parts[dev], part)
        np.testing.assert_array_equal(sess.weight_value("W"), w)
        np.testing.assert_array_equal(sess.run({"X": xv}).value("Y"),
                                      before)
    with pytest.raises(NotImplementedError, match="'torch'"):
        execute_switch(sess.weights, prog.graph, 1, 0, backend="jax")


def test_session_and_execute_plan_default_to_cuda(monkeypatch):
    """A ``Session`` given no executor runs on ``TorchExecutor`` on
    ``cuda``, and ``execute_plan`` given no device runs on ``cuda``: with
    no GPU both raise, never moving to the CPU on their own."""
    import torch
    src, dst = kind_cases(2)["AR"]
    g = api.Graph()
    g.placeholder("X", SHAPE)
    g.comm(g.tensors["X"], name="Y")
    prog = api.Program(g, [api.Strategy("s", {"X": src, "Y": dst})])
    parts = scatter(np.ones(SHAPE, np.float32), src).parts
    plan = api.resolve(src, dst, SHAPE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Session(prog, "s")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_plan(plan, parts, SHAPE)
    # resolving cuda turns TF32 off: restore the flags after the test
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ex = api.Session(prog, "s").executor
    assert isinstance(ex, api.TorchExecutor)
    assert ex.name == "torch" and ex.device.type == "cuda"
