"""The async MPMD executor and the search validator on ranks, on the CPU:
``runtime.dist_async_program``, ``api.DistAsyncExecutor`` and
``search.validate(executors=("sim", "dist"))`` against the JAX package.

The port's selftest runs its ``async`` group at 2, 4 and 8 ranks and its
``search`` group at 4 under ``gloo`` (``run_ranks``); each rank checks
``DistAsyncExecutor`` (async and serialized) against the port's
``SimulatorExecutor`` and ``DistExecutor`` bit for bit, and rank 0 writes
every run's inputs and output shards.  This process holds them against the
JAX package's ``SimulatorExecutor`` on the same inputs, bit for bit
(integer-valued data): ``async:pipeline/{2,4,8}`` (``Y`` and ``L`` at every
m and schedule) and ``async:train/4`` (losses, gradient and weight shards of
the loss pipeline and the v=2 zigzag).  (The JAX package's own
``AsyncExecutor`` fails on jax 0.9.0: ROADMAP queue C.)  ``search:hetero/4``
must give the same validation report on every rank, three bit-exact
candidates and a ``hetero`` winner, and execute the JAX package's
candidates with the JAX package's first-step losses.  Then a reduced
Qwen2 block (without its q/k/v biases, which the graph IR cannot
microbatch) trains one interleaved 1F1B step of 4 microbatches under
tp2 x pp2 on 4 ranks, on ``DistAsyncExecutor`` and on ``DistExecutor``: bitwise between
the two, and within phase 5's tolerance (loss rtol 1e-5, gradients atol
1e-6 / rtol 2e-4) of the JAX ``SimulatorExecutor``.  Every launch has a
time limit, so a hang fails the test rather than stalling the suite.
"""

import dataclasses
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro import search as jsearch  # noqa: E402
from repro.api import testing as jtesting  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.graph_block import block_program as jblock  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core.schedule import build_schedule  # noqa: E402
from repro_torch.launch import mesh as rmesh  # noqa: E402
from repro_torch.runtime import harness, selftest  # noqa: E402

NS = (2, 4, 8)
RANK_TIMEOUT = 150.0


def groups(n):
    return "async,search" if n == 4 else "async"


@pytest.fixture(scope="module")
def async_runs(tmp_path_factory):
    """``n -> (report, out dir)`` of the async (and at 4 the search)
    selftest at ``n`` ranks."""
    runs = {}

    def get(n):
        if n not in runs:
            out = tmp_path_factory.mktemp(f"async{n}")
            procs = harness.run_ranks(
                "repro_torch.runtime.selftest", n, backend="gloo",
                device="cpu", timeout=RANK_TIMEOUT,
                extra_args=["--cases", groups(n), "--out", str(out)])
            line = next(x for x in procs[0].stdout.splitlines()
                        if x.startswith("RUNTIME_SELFTEST_JSON "))
            runs[n] = (json.loads(line.split(" ", 1)[1]), str(out))
        return runs[n]
    return get


def load_case(out_dir, key):
    """``{label: {tensor: {dev: array}}}`` of one case's saved arrays."""
    got: dict = {}
    with np.load(os.path.join(out_dir,
                              selftest.safe_name(key) + ".npz")) as z:
        for k in z.files:
            label, name, dev = k.split("|")
            got.setdefault(label, {}).setdefault(name, {})[int(dev)] = z[k]
    return got


def case_of(async_runs, n, key):
    report, out = async_runs(n)
    case = report["cases"][key]
    assert case["ok"], case.get("trace")
    return case, load_case(out, key)


def assert_shards(want, got: dict, what):
    """A JAX ``ShardedTensor`` against saved ``{dev: array}``."""
    assert set(got) == set(want.parts), what
    for dev, arr in want.parts.items():
        np.testing.assert_array_equal(got[dev], arr,
                                      err_msg=f"{what} dev {dev}")
        assert got[dev].dtype == arr.dtype, (what, dev)


def inputs(saved, label="in"):
    return {name: parts[0] for name, parts in saved[label].items()}


# -- async:pipeline/{2,4,8} ------------------------------------------------

@pytest.mark.parametrize("m,kind", selftest.ASYNC_PIPE_RUNS,
                         ids=[f"m{m}-{k}" for m, k in
                              selftest.ASYNC_PIPE_RUNS])
@pytest.mark.parametrize("n", NS)
def test_async_pipeline_matches_jax_simulator(async_runs, n, m, kind):
    """``async:pipeline/{n}``: the ranks' ``Y`` and ``L`` shards of one
    (m, schedule) against the JAX simulator's, bit for bit."""
    key = f"async:pipeline/{n}"
    _, saved = case_of(async_runs, n, key)
    vals = inputs(saved)
    sess = japi.Session(jtesting.loss_pipeline_program(n, name=f"pipe{n}"),
                        f"pipe{n}", executor=japi.SimulatorExecutor())
    sess.load({k: v for k, v in vals.items() if k != "X"})
    r = sess.run({"X": vals["X"]}, fetches=["Y", "L"], num_microbatches=m,
                 schedule=kind)
    for t in ("Y", "L"):
        assert_shards(r.shards(t), saved[f"m{m}-{kind}"][t],
                      f"{key} {t} m={m} {kind}")


@pytest.mark.parametrize("n", NS)
def test_async_pipeline_programs_and_channels(async_runs, n):
    """One fwd and one bwd program per virtual stage over the ranks, as
    the JAX package counts its stages; a ``p2p`` channel, and at n >= 4
    (stages of 2 devices: partial gradients) a ``reduce`` channel."""
    case, _ = case_of(async_runs, n, f"async:pipeline/{n}")
    n_virtual = jtesting.loss_pipeline_program(n, name="p").compile(
        "p").n_stages
    assert case["programs"] == 2 * n_virtual
    assert "p2p" in case["channel_kinds"]
    assert ("reduce" in case["channel_kinds"]) == (n >= 4)


# -- async:train/4 -----------------------------------------------------------

@pytest.mark.parametrize("m,kind", selftest.ASYNC_TRAIN_RUNS,
                         ids=[f"m{m}-{k}" for m, k in
                              selftest.ASYNC_TRAIN_RUNS])
def test_async_train_matches_jax_simulator(async_runs, m, kind):
    """The loss pipeline trained on 4 ranks: loss, gradient and updated
    weight shards bitwise the JAX simulator's."""
    _, saved = case_of(async_runs, 4, "async:train/4")
    vals = inputs(saved)
    ws = {k: v for k, v in vals.items() if k != "X"}
    sess = japi.Session(jtesting.loss_pipeline_program(4, name="pipe4"),
                        "pipe4", executor=japi.SimulatorExecutor())
    sess.load(ws)
    r = sess.train_step({"X": vals["X"]}, num_microbatches=m, schedule=kind)
    assert float(saved[f"m{m}-{kind}-loss"]["L"][0]) == r.loss
    for w in ws:
        assert_shards(r.grads[w], saved[f"m{m}-{kind}-grad"][w],
                      f"grad {w} m={m} {kind}")
        assert_shards(sess.weights[w], saved[f"m{m}-{kind}-weight"][w],
                      f"weight {w} m={m} {kind}")


@pytest.mark.parametrize("m", (1, 2, 4))
def test_async_zigzag_train_matches_jax_simulator(async_runs, m):
    """The v=2 zigzag trained under the interleaved schedule on 4 ranks
    (each rank two virtual stages): bitwise the JAX simulator's."""
    _, saved = case_of(async_runs, 4, "async:train/4")
    vals = inputs(saved, "zin")
    ws = {k: v for k, v in vals.items() if k != "X"}
    sess = japi.Session(jtesting.zigzag_program(4, name="zig4"), "zig4",
                        executor=japi.SimulatorExecutor())
    sess.load(ws)
    r = sess.train_step({"X": vals["X"]}, num_microbatches=m,
                        schedule="interleaved")
    assert float(saved[f"zig-m{m}-loss"]["L"][0]) == r.loss
    for w in ws:
        assert_shards(r.grads[w], saved[f"zig-m{m}-grad"][w],
                      f"zig grad {w} m={m}")
        assert_shards(sess.weights[w], saved[f"zig-m{m}-weight"][w],
                      f"zig weight {w} m={m}")


# -- search:hetero/4 ---------------------------------------------------------

def test_search_validates_on_ranks_as_the_reference(async_runs):
    """``search:hetero/4``: the same validation report on every rank (the
    selftest gathers it), three candidates executed and bit-exact on the
    ranks, agreement at least 2/3, a ``hetero`` winner; and the same
    candidates, microbatching and first-step losses as the JAX package's
    searcher validating on its simulator."""
    report, _ = async_runs(4)
    case = report["cases"]["search:hetero/4"]
    assert case["ok"], case.get("trace")
    assert case["ranks_agree"] == 4
    assert case["agreement"] >= 2 / 3
    assert case["winner"].startswith("het")
    got = case["executed"]
    assert len(got) == 3 and all(e[9] is True and e[10] is None
                                 for e in got)
    searcher = jsearch.Searcher(
        jsearch.tiny_spec(), global_batch=8, seq_len=128, tp_options=(1, 2),
        pp_options=(1, 2), pipeline_options=(1, 2), virtual_options=(1,))
    want = searcher.search(jsearch.cpu_hetero_cluster(2, 2), validate_top=3,
                           repeats=1, batch=64, d=64, f=128)
    assert [e[:3] + [e[8]] for e in got] == \
        [[e.name, e.m, e.schedule, e.loss] for e in want.validation.executed]
    assert case["winner"] == want.best.candidate.name
    assert case["collectives"] > 0


@pytest.mark.parametrize("n", NS)
def test_async_report_is_whole(async_runs, n):
    report, _ = async_runs(n)
    assert report["ok"] and report["ranks"] == n
    want = {f"async:pipeline/{n}"}
    if n == 4:
        want |= {"async:train/4", "search:hetero/4"}
    assert set(report["cases"]) == want
    # every case reports the traffic of its rank runs
    for key, c in report["cases"].items():
        assert c["collectives"] > 0 and c["p2p_messages"] > 0, key
        assert c["staged_bytes"] == 0, key        # CPU shards: no staging


# -- a reduced Qwen2 block under tp2 x pp2 on 4 ranks -------------------------

S, B, M = 128, 4, 4

#: each rank: the test's weights from seed 0, one interleaved 1F1B step of
#: M microbatches on DistAsyncExecutor, then on DistExecutor; rank 0 writes
#: the losses, gradients and each lowering's attention dispatches
BLOCK_RANK = """
import argparse, dataclasses
import numpy as np
from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_runtime_mesh
from repro_torch.models.graph_block import block_program
ap = argparse.ArgumentParser()
ap.add_argument("--backend"); ap.add_argument("--device")
ap.add_argument("--out")
args = ap.parse_args()
mesh = make_runtime_mesh(backend=args.backend, device=args.device)
cfg = dataclasses.replace(get_config("qwen2_1_5b").reduced(), qkv_bias=False)
prog = block_program(cfg, batch=%(B)d, seq=%(S)d, dp=1, tp=2, pp=2)
arrays = {}
for tag, ex in (("async", api.DistAsyncExecutor(mesh)),
                ("dist", api.DistExecutor(mesh))):
    rng = np.random.default_rng(0)
    feeds = {k: rng.integers(0, cfg.vocab, (%(B)d, %(S)d)).astype(np.int32)
             for k in ("ids", "labels")}
    ws = {t.name: np.ones(t.shape, np.float32)
          if "norm" in t.name.split("/")[-1]
          else (rng.standard_normal(t.shape) * 0.05).astype(np.float32)
          for t in prog.graph.parameters()}
    sess = api.Session(prog, 0, executor=ex)
    sess.load(ws)
    r = sess.train_step(dict(feeds), num_microbatches=%(M)d,
                        schedule="interleaved")
    arrays[f"{tag}|loss"] = np.float64(r.loss)
    for n in ws:
        arrays[f"{tag}|grad|{n}"] = r.grad_value(n)
        for dev, part in r.grads[n].parts.items():
            arrays[f"{tag}|part|{n}|{dev}"] = part
    tplan = prog.compile_train(0, num_microbatches=%(M)d)
    fetches = [tplan.loss_name] + [tplan.grad_map[t.name]
                                   for t in tplan.graph.parameters()]
    lw = ex.lowered(tplan, fetches) if tag == "async" else \\
        ex.lowered(tplan, fetches, %(M)d)
    arrays[f"{tag}|dispatches"] = np.array([lw.stats.ref_dispatches,
                                            lw.stats.kernel_dispatches])
if mesh.rank == 0:
    np.savez(args.out, **arrays)
""" % dict(B=B, S=S, M=M)


@pytest.fixture(scope="module")
def block_run(tmp_path_factory):
    """Rank 0's arrays of the block run."""
    out = str(tmp_path_factory.mktemp("block") / "block.npz")
    harness.run_ranks(BLOCK_RANK, 4, backend="gloo", device="cpu",
                      timeout=RANK_TIMEOUT, extra_args=["--out", out])
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def test_qwen2_block_pipeline_on_ranks_is_bitwise_the_rank_executor(
        block_run):
    """The same one-row class calls on each rank in both executors: the
    loss and every gradient part bitwise; one attention layer a stage, so
    each rank's lowering dispatches one attention class (the plain
    version on the CPU)."""
    parts = {k for k in block_run if k.startswith("dist|part|")}
    assert parts
    assert float(block_run["async|loss"]) == float(block_run["dist|loss"])
    for k in parts:
        np.testing.assert_array_equal(
            block_run[k.replace("dist|", "async|", 1)], block_run[k],
            err_msg=k)
    for tag in ("async", "dist"):
        assert list(block_run[f"{tag}|dispatches"]) == [1, 0], tag


def test_qwen2_block_pipeline_on_ranks_like_the_jax_simulator(block_run):
    cfg = dataclasses.replace(jget_config("qwen2_1_5b").reduced(),
                              qkv_bias=False)
    prog = jblock(cfg, batch=B, seq=S, dp=1, tp=2, pp=2)
    rng = np.random.default_rng(0)
    feeds = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("ids", "labels")}
    ws = {t.name: np.ones(t.shape, np.float32)
          if "norm" in t.name.split("/")[-1]
          else (rng.standard_normal(t.shape) * 0.05).astype(np.float32)
          for t in prog.graph.parameters()}
    ref = japi.Session(prog, 0, executor=japi.SimulatorExecutor())
    ref.load(ws)
    want = ref.train_step(dict(feeds), num_microbatches=M,
                          schedule="interleaved")
    np.testing.assert_allclose(float(block_run["async|loss"]), want.loss,
                               rtol=1e-5, atol=1e-9)
    for n in ws:
        np.testing.assert_allclose(block_run[f"async|grad|{n}"],
                                   want.grad_value(n), atol=1e-6, rtol=2e-4,
                                   err_msg=n)


# -- an invalid timetable on ranks --------------------------------------------

#: each of 2 ranks: pipe2's micro train plan, its microbatch states, and
#: two invalid timetables: one whose first tick runs stage 1 before stage 0
#: (``early``) and one that drops its last tick (``short``)
PIPE2_RANK = """
import argparse, dataclasses, json
import numpy as np
from repro_torch import api
from repro_torch.api import testing
from repro_torch.launch.mesh import make_runtime_mesh
ap = argparse.ArgumentParser()
ap.add_argument("--backend"); ap.add_argument("--device")
args = ap.parse_args()
mesh = make_runtime_mesh(backend=args.backend, device=args.device)
xv, ws, want_y = testing.loss_pipeline_values(seed=11)
prog = testing.loss_pipeline_program(2, name="pipe2")
holder = api.Session(prog, "pipe2", executor=api.SimulatorExecutor())
holder.load(ws)
tplan = prog.compile_train("pipe2", num_microbatches=2)
states = [{"X": api.scatter(f["X"], tplan.graph.tensors["X"].annots[0]),
           **{w: holder.weights[w] for w in ws}}
          for f in holder._split_feeds({"X": xv}, tplan)]
sched = api.build_schedule(2, 2, "1f1b")
first = [t for t in sched.ticks if t.stage == 1][:1]
early = dataclasses.replace(
    sched, ticks=first + [t for t in sched.ticks if t is not first[0]])
short = dataclasses.replace(sched, ticks=sched.ticks[:-1])
ex = api.DistAsyncExecutor(mesh)
out = {}
for name, bad in (("early", early), ("short", short)):
    try:
        ex.run_schedule(tplan, bad, states)
        out[name] = None
    except api.ScheduleError as e:
        out[name] = str(e)
"""

#: ... both must raise ScheduleError on every rank, then the valid one runs
INVALID_RANK = PIPE2_RANK + """
got = ex.run_schedule(tplan, sched, states)
out["valid"] = float(sum(np.asarray(api.gather(r[tplan.loss_name]))
                         for r in got))
out["want"] = float(want_y.sum())
print("INVALID_JSON " + json.dumps(out), flush=True)
"""

#: ... both raise on every rank, and the rank exits at once
RAISE_RANK = PIPE2_RANK + """
print("RAISED_JSON " + json.dumps(out), flush=True)
"""

#: rank 1 raises an uncaught error while rank 0 waits for it in a barrier
UNCAUGHT_RANK = """
import argparse
import torch.distributed as dist
from repro_torch.launch.mesh import make_runtime_mesh
ap = argparse.ArgumentParser()
ap.add_argument("--backend"); ap.add_argument("--device")
args = ap.parse_args()
mesh = make_runtime_mesh(backend=args.backend, device=args.device)
if mesh.rank == 1:
    raise ValueError("rank 1 fails")
dist.barrier()
"""


def rank_json(proc, tag):
    return json.loads(next(x for x in proc.stdout.splitlines()
                           if x.startswith(tag + " ")).split(" ", 1)[1])


def test_invalid_timetable_raises_on_every_rank():
    procs = harness.run_ranks(INVALID_RANK, 2, backend="gloo",
                              device="cpu", timeout=RANK_TIMEOUT)
    outs = [rank_json(p, "INVALID_JSON") for p in procs]
    assert outs[0] == outs[1]
    assert "ran before its input" in outs[0]["early"]
    assert "never produced" in outs[0]["short"]
    assert outs[0]["valid"] == outs[0]["want"]


def test_ranks_that_raise_then_exit_end_cleanly():
    """Every rank raises (and catches) ScheduleError inside the executor's
    exchanges and then exits: the process group is torn down at exit
    (``launch.mesh``), so every rank exits 0 and writes nothing to its
    stderr (a gloo group left to the interpreter's shutdown could abort
    the rank there: "terminate called without an active exception")."""
    procs = harness.run_ranks(RAISE_RANK, 2, backend="gloo", device="cpu",
                              timeout=RANK_TIMEOUT)
    for p in procs:
        assert p.returncode == 0
        assert p.stderr == "", p.stderr
        out = rank_json(p, "RAISED_JSON")
        assert "ran before its input" in out["early"]
        assert "never produced" in out["short"]


def test_an_uncaught_error_ends_the_launch_at_once():
    """A rank that dies of an uncaught error does not wait on its peers at
    exit: it exits 1 with its traceback, and ``run_ranks`` stops the rank
    still waiting for it in a barrier long before the launch's limit."""
    t0 = time.monotonic()
    with pytest.raises(harness.RankError, match="exited with code 1") as err:
        harness.run_ranks(UNCAUGHT_RANK, 2, backend="gloo", device="cpu",
                          timeout=RANK_TIMEOUT)
    assert time.monotonic() - t0 < RANK_TIMEOUT / 3
    assert "ValueError: rank 1 fails" in err.value.outputs[1].stderr
    assert "terminate called" not in err.value.outputs[1].stderr


# -- in this process ----------------------------------------------------------

def test_dist_async_executor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.DistAsyncExecutor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_executor("dist-async")


@pytest.fixture
def world_of_one(tmp_path, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", rmesh.INIT_ENV):
        monkeypatch.delenv(var, raising=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_get_executor_dist_async_runs_a_one_device_session(world_of_one):
    """``get_executor("dist-async", device="cpu")`` over a one-rank world:
    an AsyncExecutor (its cache, schedules and checks) whose one-device
    program matches the simulator bit for bit; a program wider than the
    world raises."""
    ex = api.get_executor("dist-async", device="cpu", serialize=True)
    assert isinstance(ex, api.DistAsyncExecutor) and ex.name == "dist-async"
    assert isinstance(ex, api.AsyncExecutor) and ex.serialize
    assert isinstance(ex, api.Executor) and ex.device.type == "cpu"
    g = api.Graph()
    g.placeholder("X", (4, 8))
    g.parameter("W", (8, 3))
    g.sum(g.sum(g.relu(g.dot(g.tensors["X"], g.tensors["W"], name="H")), 1,
                name="L1"), 0, name="L")
    one = api.Program(g, [api.Strategy("one", {
        "X": api.spmd([0], api.DS({})), "W": api.spmd([0], api.DS({}))})])
    rng = np.random.default_rng(0)
    xv = rng.integers(-4, 5, (4, 8)).astype(np.float32)
    wv = rng.integers(-4, 5, (8, 3)).astype(np.float32)
    outs = {}
    for e in (api.SimulatorExecutor(), ex):
        sess = api.Session(one, "one", executor=e)
        sess.load({"W": wv})
        outs[e.name] = sess.train_step({"X": xv}, num_microbatches=2)
    assert outs["dist-async"].loss == outs["sim"].loss
    np.testing.assert_array_equal(outs["dist-async"].grad_value("W"),
                                  outs["sim"].grad_value("W"))
    assert ex.traffic().collectives > 0       # the fetches' gathers
    sess = api.Session(selftest.session_program(2), "pipe", executor=ex)
    vals = selftest.session_values()
    sess.load({"W1": vals["W1"], "W2": vals["W2"]})
    with pytest.raises(ValueError, match="spans 2 logical devices"):
        sess.run({"X": vals["X"]})


def test_dist_async_executor_checks_the_schedule(world_of_one):
    """The schedule checks are ``AsyncExecutor``'s, made before anything
    is lowered."""
    ex = api.DistAsyncExecutor(device="cpu")
    sched = build_schedule(2, 2, "1f1b")
    with pytest.raises(api.ScheduleError, match="microbatch states"):
        ex.run_schedule(SimpleNamespace(n_stages=2), sched, [{}])
    with pytest.raises(api.ScheduleError, match="stage"):
        ex.run_schedule(SimpleNamespace(n_stages=3), sched, [{}, {}])
    with pytest.raises(api.ScheduleError, match="'ring'"):
        ex.run_schedule(SimpleNamespace(n_stages=2),
                        dataclasses.replace(sched, kind="ring"), [{}, {}])
