"""``AsyncExecutor`` on the CPU against the JAX package's simulator.

The port's async MPMD executor (``repro_torch.runtime.async_program``)
runs one program per (virtual stage, phase) over stacked rows, the
explicit timetable as its dispatch order.  On the CPU its dispatch loop
runs in order, with no streams.  Every comparison is bit for bit, shard
by shard:

* the torch versions of the reference's ``async:pipeline/{2,4,8}`` and
  ``async:train/4`` selftest cases (``repro/runtime/selftest.py``): the
  JAX package's ``SimulatorExecutor`` is the oracle, for the async path
  and for ``serialize=True`` alike (the JAX package's own
  ``AsyncExecutor`` is not: it fails on jax 0.9.0, see ROADMAP queue C),
* reduced Llama under tp2 x pp2 against ``TorchExecutor(device="cpu")``
  bitwise, and against the JAX package's simulator within
  ``tests/test_torch_graph_block.py``'s tolerances,
* the lowering's structure: ``describe()`` equal to the JAX package's
  lowering of the same plan (built in a child process, which needs
  forced host devices), the selftest's program and channel counts,
* the registry and error surfaces of ``tests/test_async.py``, with the
  same messages.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.api import testing as jtesting  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.graph_block import block_program as jblock  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import testing as ttesting  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.schedule import build_schedule  # noqa: E402
from repro_torch.models.graph_block import block_program  # noqa: E402

JAX = SimpleNamespace(api=japi, testing=jtesting)
PORT = SimpleNamespace(api=api, testing=ttesting)
NS = (2, 4, 8)
PIPE_RUNS = [(1, "1f1b")] + [(m, kind) for m in (2, 4)
                             for kind in ("1f1b", "gpipe", "interleaved")]
TRAIN_RUNS = [(1, "1f1b"), (2, "1f1b"), (4, "1f1b"), (4, "gpipe")]


def executors():
    """``(name, package, executor)``: the JAX package's simulator (the
    oracle), the async executor and its serialized baseline."""
    return [("ref", JAX, japi.SimulatorExecutor()),
            ("async", PORT, api.AsyncExecutor(device="cpu")),
            ("serial", PORT, api.AsyncExecutor(device="cpu",
                                               serialize=True))]


def assert_shards_equal(want, got, what=""):
    assert set(got.parts) == set(want.parts), what
    for dev, arr in want.parts.items():
        np.testing.assert_array_equal(got.parts[dev], arr,
                                      err_msg=f"{what} dev {dev}")
        assert got.parts[dev].dtype == arr.dtype, (what, dev)


# -- async:pipeline/{2,4,8} ------------------------------------------------

@pytest.mark.parametrize("m,kind", PIPE_RUNS,
                         ids=[f"m{m}-{k}" for m, k in PIPE_RUNS])
@pytest.mark.parametrize("n", NS)
def test_async_pipeline_matches_simulator(n, m, kind):
    """``Y`` and the Partial loss ``L`` per device shard, bit for bit
    against the reference simulator at the same (m, kind)."""
    xv, ws, want_y = ttesting.loss_pipeline_values(seed=11)
    outs = {}
    for name, pkg, ex in executors():
        prog = pkg.testing.loss_pipeline_program(n, name=f"pipe{n}")
        sess = pkg.api.Session(prog, f"pipe{n}", executor=ex)
        sess.load(ws)
        r = sess.run({"X": xv}, fetches=["Y", "L"], num_microbatches=m,
                     schedule=kind)
        np.testing.assert_array_equal(r.value("Y"), want_y)
        assert float(r.value("L")) == float(want_y.sum())
        outs[name] = r
    for name in ("async", "serial"):
        for t in ("Y", "L"):
            assert_shards_equal(outs["ref"].shards(t), outs[name].shards(t),
                                f"{t} {name} n={n} m={m} {kind}")


@pytest.mark.parametrize("n", NS)
def test_per_stage_programs_and_channels(n):
    """One fwd + one bwd program per virtual stage; the boundary sends
    run as p2p channels and, from n = 4 (stages of more than one device,
    so Partial gradients), the grad-reduce as a reduce channel."""
    prog = ttesting.loss_pipeline_program(n, name=f"pipe{n}")
    lw = api.AsyncExecutor(device="cpu").lowered(
        prog.compile_train(f"pipe{n}"))
    n_virtual = prog.compile(f"pipe{n}").n_stages
    assert n_virtual == lw.n_virtual == 2
    assert len(lw.programs) == 2 * n_virtual, sorted(lw.programs)
    kinds = [ch.kind for ch in lw.channels]
    assert "p2p" in kinds, kinds
    assert ("reduce" in kinds) == (n >= 4), kinds
    assert lw.describe().splitlines()[0] == (
        f"4 stage program(s), {len(kinds)} comm channel(s) over 2 virtual "
        f"stage(s) (S=2, v=1)")


# -- async:train/4 ---------------------------------------------------------

def _train(pkg, ex, build, strat, xv, ws, m, kind):
    sess = pkg.api.Session(build(pkg), strat, executor=ex)
    sess.load(ws)
    r = sess.train_step({"X": xv}, num_microbatches=m, schedule=kind)
    return r, dict(sess.weights)


@pytest.mark.parametrize("m,kind", TRAIN_RUNS,
                         ids=[f"m{m}-{k}" for m, k in TRAIN_RUNS])
def test_async_train_matches_simulator(m, kind):
    """``pipe4`` training: the loss, every gradient shard and every
    updated weight shard against the reference simulator's unpipelined
    step, as the selftest holds them."""
    xv, ws, want_y = ttesting.loss_pipeline_values(seed=11)

    def build(pkg):
        return pkg.testing.loss_pipeline_program(4, name="pipe4")
    base, base_w = _train(JAX, japi.SimulatorExecutor(), build, "pipe4",
                          xv, ws, 1, "1f1b")
    for name, pkg, ex in executors():
        r, w = _train(pkg, ex, build, "pipe4", xv, ws, m, kind)
        assert r.loss == float(want_y.sum()), name
        for t in ws:
            assert_shards_equal(base.grads[t], r.grads[t], f"grad {t} {name}")
            assert_shards_equal(base_w[t], w[t], f"weight {t} {name}")


@pytest.mark.parametrize("m", (1, 2, 4))
def test_async_zigzag_train_matches_simulator(m):
    """Interleaved v=2 training: one device's two chunks run as distinct
    per-chunk programs (four virtual stages)."""
    xv, ws, want_y = ttesting.zigzag_values(seed=13)

    def build(pkg):
        return pkg.testing.zigzag_program(4, name="zig4")
    base, _ = _train(JAX, japi.SimulatorExecutor(), build, "zig4", xv, ws,
                     1, "interleaved")
    for name, pkg, ex in executors():
        r, _ = _train(pkg, ex, build, "zig4", xv, ws, m, "interleaved")
        assert r.loss == float(want_y.sum()), name
        for t in ws:
            assert_shards_equal(base.grads[t], r.grads[t], f"grad {t} {name}")
    lw = api.AsyncExecutor(device="cpu").lowered(
        build(PORT).compile_train("zig4"))
    assert (lw.v, lw.n_virtual, len(lw.programs)) == (2, 4, 8)


# -- reduced Llama, tp2 x pp2 ----------------------------------------------

LLAMA_B, LLAMA_S = 4, 128
LLAMA_RUNS = [(2, "1f1b"), (2, "gpipe"), (4, "1f1b"), (4, "gpipe")]


def _llama():
    cfg = get_config("llama_32b").reduced()
    rng = np.random.default_rng(0)
    feeds = {k: rng.integers(0, cfg.vocab, (LLAMA_B, LLAMA_S))
             .astype(np.int32) for k in ("ids", "labels")}
    prog = block_program(cfg, batch=LLAMA_B, seq=LLAMA_S, dp=1, tp=2, pp=2)
    ws = {t.name: np.ones(t.shape, np.float32)
          if "norm" in t.name.split("/")[-1]
          else (rng.standard_normal(t.shape) * 0.05).astype(np.float32)
          for t in prog.graph.parameters()}
    return cfg, prog, feeds, ws


@pytest.mark.parametrize("m,kind", LLAMA_RUNS,
                         ids=[f"m{m}-{k}" for m, k in LLAMA_RUNS])
def test_llama_tp2_pp2_matches_torch_executor(m, kind):
    """Reduced Llama blocks under tp2 x pp2: async and serialized async
    bitwise equal to ``TorchExecutor`` (the same class calls on the same
    rows), and the loss and gradients within ``test_archs``' tolerance of
    the JAX package's simulator (loss rtol 1e-5; grads atol 1e-6, rtol
    2e-4)."""
    cfg, prog, feeds, ws = _llama()
    ref = japi.Session(jblock(jget_config("llama_32b").reduced(),
                              batch=LLAMA_B, seq=LLAMA_S, dp=1, tp=2, pp=2),
                       0, executor=japi.SimulatorExecutor())
    ref.load(ws)
    want = ref.train_step(dict(feeds), num_microbatches=m, schedule=kind)
    runs = {}
    for ex in (api.TorchExecutor(device="cpu"),
               api.AsyncExecutor(device="cpu"),
               api.AsyncExecutor(device="cpu", serialize=True)):
        sess = api.Session(prog, 0, executor=ex)
        sess.load(ws)
        runs[(ex.name, getattr(ex, "serialize", None))] = sess.train_step(
            dict(feeds), num_microbatches=m, schedule=kind)
    base = runs[("torch", None)]
    np.testing.assert_allclose(base.loss, want.loss, rtol=1e-5, atol=1e-9)
    for n in ws:
        np.testing.assert_allclose(base.grad_value(n), want.grad_value(n),
                                   atol=1e-6, rtol=2e-4, err_msg=n)
    for key in (("async", False), ("async", True)):
        r = runs[key]
        assert r.loss == base.loss, key
        for n in ws:
            assert_shards_equal(base.grads[n], r.grads[n], f"{key} {n}")
    tplan = prog.compile_train(0, num_microbatches=m)
    lw = api.AsyncExecutor(device="cpu").lowered(tplan, [tplan.loss_name])
    # attention: one class per layer, the plain version on the CPU
    assert (lw.stats.ref_dispatches, lw.stats.kernel_dispatches) == \
        (cfg.n_layers, 0)


# -- the lowering's structure against the JAX package's --------------------

def _describe_cases(pkg):
    """name -> (compiled train plan, fetches) for both packages."""
    t = pkg.testing
    out = {}
    for n in NS:
        out[f"pipe{n}"] = t.loss_pipeline_program(n, name="p") \
            .compile_train("p")
    out["zig4"] = t.zigzag_program(4, name="z").compile_train("z")
    cfg = pkg.get_config("llama_32b").reduced()
    prog = pkg.block_program(cfg, batch=LLAMA_B, seq=LLAMA_S, dp=1, tp=2,
                             pp=2)
    out["llama"] = prog.compile_train(0, num_microbatches=2)
    return out


CHILD = textwrap.dedent("""
    import json
    from types import SimpleNamespace
    from repro import api
    from repro.api import testing
    from repro.configs import get_config
    from repro.models.graph_block import block_program
    import repro.runtime.async_program as ap
    import test_torch_async as t
    # nothing is run here: skip the x64 scope, whose import fails on jax
    # 0.9.0 (ROADMAP queue C), around the reducing channels
    ap.maybe_x64 = lambda fn, needs_x64: fn
    pkg = SimpleNamespace(testing=testing, get_config=get_config,
                          block_program=block_program)
    ex = api.AsyncExecutor()
    print(json.dumps({k: ex.lowered(plan).describe()
                      for k, plan in t._describe_cases(pkg).items()}))
""")


@pytest.fixture(scope="module")
def reference_describe():
    """The JAX package's ``AsyncLoweredGraph.describe()`` of every case,
    in a child process with 8 forced host devices (its lowering builds a
    mesh); nothing there is run."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu")
    here = Path(__file__).resolve().parent
    env["PYTHONPATH"] = os.pathsep.join(
        [str(here), str(here.parent / "src"), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", CHILD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["pipe2", "pipe4", "pipe8", "zig4",
                                  "llama"])
def test_describe_matches_the_reference_lowering(case, reference_describe):
    """The same buckets, op counts, inputs/outputs and channels (kind,
    tensors, trigger) as the JAX package's per-stage lowering."""
    pkg = SimpleNamespace(testing=ttesting, get_config=get_config,
                          block_program=block_program)
    plan = _describe_cases(pkg)[case]
    got = api.AsyncExecutor(device="cpu").lowered(plan).describe()
    assert got == reference_describe[case]


# -- registry and error surfaces (tests/test_async.py) ---------------------

def test_get_executor_registry_includes_async():
    ex = api.get_executor("async", device="cpu")
    assert isinstance(ex, api.AsyncExecutor)
    assert isinstance(ex, api.Executor)
    assert ex.name == "async"
    assert set(ex.supported_schedules) == {"1f1b", "gpipe", "interleaved"}
    # constructor kwargs pass through like the other executors'
    assert api.get_executor("async", device="cpu", serialize=True).serialize
    with pytest.raises(TypeError):
        api.get_executor("async", device="cpu", record_ticks=True)


def test_unknown_executor_error_lists_valid_names():
    with pytest.raises(ValueError) as e:
        api.get_executor("tpu")
    msg = str(e.value)
    for name in ("async", "sim", "torch"):
        assert name in msg, msg
    assert "tpu" in msg


def test_async_executor_rejects_unknown_schedule_kind():
    """run_schedule validates the kind BEFORE lowering anything, so a
    bogus timetable fails fast with the supported kinds listed."""
    sched = dataclasses.replace(build_schedule(2, 2, "1f1b"), kind="ring")
    ex = api.AsyncExecutor(device="cpu")
    with pytest.raises(api.ScheduleError) as e:
        ex.run_schedule(SimpleNamespace(n_stages=2), sched, [{}, {}])
    msg = str(e.value)
    assert "'ring'" in msg
    for kind in ("1f1b", "gpipe", "interleaved"):
        assert kind in msg, msg


def test_async_executor_rejects_mismatched_states_and_stages():
    sched = build_schedule(2, 2, "1f1b")
    ex = api.AsyncExecutor(device="cpu")
    with pytest.raises(api.ScheduleError, match="microbatch"):
        ex.run_schedule(SimpleNamespace(n_stages=2), sched, [{}])
    with pytest.raises(api.ScheduleError, match="stage"):
        ex.run_schedule(SimpleNamespace(n_stages=3), sched, [{}, {}])


def test_session_rejects_kind_unsupported_by_executor():
    """Session consults executor.supported_schedules up front: an
    executor that only speaks gpipe turns a 1f1b request into a
    structured error naming the executor and its kinds."""
    class GPipeOnly(api.AsyncExecutor):
        name = "gpipe-only"
        supported_schedules = ("gpipe",)

    prog = ttesting.loss_pipeline_program(2, name="pipe2")
    xv, ws, want_y = ttesting.loss_pipeline_values(seed=11)
    sess = api.Session(prog, "pipe2", executor=GPipeOnly(device="cpu"))
    sess.load(ws)
    r = sess.run({"X": xv}, fetches=["Y"], num_microbatches=2,
                 schedule="gpipe")
    np.testing.assert_array_equal(r.value("Y"), want_y)
    with pytest.raises(api.ScheduleError) as e:
        sess.run({"X": xv}, fetches=["Y"], num_microbatches=2,
                 schedule="1f1b")
    msg = str(e.value)
    assert "gpipe-only" in msg and "'gpipe'" in msg, msg
    # unknown kinds still fail on the global list first
    with pytest.raises(api.ScheduleError, match="interleaved"):
        sess.run({"X": xv}, fetches=["Y"], num_microbatches=2,
                 schedule="ring")


# -- the port's own contract ------------------------------------------------

def test_async_executor_defaults_to_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.AsyncExecutor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_executor("async", serialize=True)
    assert api.AsyncExecutor(device="cpu").device.type == "cpu"


def _pipe4_states(m):
    """pipe4's micro train plan and per-microbatch leaf states, as the
    Session builds them."""
    xv, ws, _ = ttesting.loss_pipeline_values(seed=11)
    prog = ttesting.loss_pipeline_program(4, name="pipe4")
    sess = api.Session(prog, "pipe4", executor=api.SimulatorExecutor())
    sess.load(ws)
    tplan = prog.compile_train("pipe4", num_microbatches=m)
    feeds = sess._split_feeds({"X": xv}, tplan)
    states = [{"X": api.scatter(f["X"], tplan.graph.tensors["X"].annots[0],
                                rng=np.random.default_rng(0)),
               **{w: sess.weights[w] for w in ws}} for f in feeds]
    return tplan, states


def test_invalid_timetable_raises_schedule_error():
    """A tick before its input (stage 1's forward ahead of stage 0's)
    raises, as does a timetable that skips a tick."""
    tplan, states = _pipe4_states(2)
    sched = build_schedule(2, 2, "1f1b")
    ex = api.AsyncExecutor(device="cpu")
    first = [t for t in sched.ticks if t.stage == 1][:1]
    early = dataclasses.replace(
        sched, ticks=first + [t for t in sched.ticks if t is not first[0]])
    with pytest.raises(api.ScheduleError, match="ran before its input"):
        ex.run_schedule(tplan, early, states)
    short = dataclasses.replace(sched, ticks=sched.ticks[:-1])
    with pytest.raises(api.ScheduleError):
        ex.run_schedule(tplan, short, states)
    # the valid timetable runs on the same states
    assert len(ex.run_schedule(tplan, sched, states)) == 2


def test_lowered_graph_is_cached_per_plan_fetches_and_v():
    ex = api.AsyncExecutor(device="cpu")
    prog = ttesting.zigzag_program(4, name="zig4")
    plan = prog.compile_train("zig4")
    lw = ex.lowered(plan)
    assert ex.lowered(plan) is lw
    assert ex.lowered(plan, virtual_stages_per_device=2) is lw
    assert ex.lowered(plan, [plan.loss_name]) is not lw
    assert ex.lowered(plan, [plan.loss_name]) is \
        ex.lowered(plan, [plan.loss_name])
    assert ex.lowered(plan, virtual_stages_per_device=3) is not lw
    other = ttesting.zigzag_program(4, name="zig4").compile_train("zig4")
    assert ex.lowered(other) is not lw
