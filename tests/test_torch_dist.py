"""The rank runtime on the CPU: ``launch.mesh``, ``runtime.harness``,
``runtime.dist_lowering``, ``runtime.backend``, ``runtime.diff`` and
``runtime.selftest`` against the JAX package's simulator.

The port's selftest runs as 2, 4 and 8 ranks under ``gloo``
(``run_ranks``), each rank checking every case bit for bit against the
port's simulator and rank 0 writing each case's shards.  This process
holds those shards against the JAX package's ``simulator.apply_plan`` on
the JAX package's own plans, bit for bit: every CommStep kind on random
normal shards (the float64 fold in ``srcs`` order) and on integer shards
(the native-dtype ``all_reduce``), the paper's Fig 9 stage, a non-uniform
``hsplits`` stage and the round trips.  The rest runs in this process:
the backend choice, a plan wider than the world, and the harness's
handling of a rank that fails or hangs.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core.simulator import apply_plan as japply_plan  # noqa: E402
from repro.core.specialize import resolve_comm_ops as jresolve_comm_ops  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.launch import mesh as rmesh  # noqa: E402
from repro_torch.runtime import backend, harness, selftest  # noqa: E402

NS = (2, 4, 8)
#: each selftest run's time limit; the three together take ~25 s here
RANK_TIMEOUT = 150.0


def load_case(out_dir, key):
    """``{label: {dev: shard}}`` of one case's saved arrays."""
    got: dict = {}
    with np.load(os.path.join(out_dir,
                              selftest.safe_name(key) + ".npz")) as z:
        for k in z.files:
            label, _, dev = k.split("|")
            got.setdefault(label, {})[int(dev)] = z[k]
    return got


def report_of(proc):
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RUNTIME_SELFTEST_JSON "))
    return json.loads(line.split(" ", 1)[1])


@pytest.fixture(scope="module")
def comm_runs(tmp_path_factory):
    """``n -> (report, out dir)`` of the comm selftest at ``n`` ranks,
    each run once, when a test first asks for it."""
    runs = {}

    def get(n):
        if n not in runs:
            out = tmp_path_factory.mktemp(f"comm{n}")
            procs = harness.run_ranks(
                "repro_torch.runtime.selftest", n, backend="gloo",
                device="cpu", timeout=RANK_TIMEOUT,
                extra_args=["--cases", "comm", "--out", str(out)])
            runs[n] = (report_of(procs[0]), str(out))
        return runs[n]
    return get


def assert_parts_equal(want, got, what):
    assert set(got) == set(want), what
    for dev, arr in want.items():
        np.testing.assert_array_equal(got[dev], arr,
                                      err_msg=f"{what} dev {dev}")
        assert got[dev].dtype == arr.dtype, (what, dev)


def held_against_jax(comm_runs, n, key, jplan, shape):
    report, out = comm_runs(n)
    case = report["cases"][key]
    assert case["ok"], case.get("trace")
    saved = load_case(out, key)
    want = japply_plan(japi.ShardedTensor(shape, jplan.src, saved["src"]),
                       jplan)
    assert_parts_equal(want.parts, saved["dst"], key)
    return case


@pytest.mark.parametrize("shards", ["exact", "integer"])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", selftest.KINDS)
def test_commstep_kind_matches_jax_simulator(comm_runs, kind, n, shards):
    """``shards="exact"``: random normal summands under ``reduction=
    "exact"``; ``"integer"``: integer summands under ``"fast"``."""
    key = f"{'int:' if shards == 'integer' else ''}{kind}/{n}"
    jsrc, jdst = selftest.kind_cases(n, japi)[kind]
    jplan = japi.resolve(jsrc, jdst, selftest.SHAPE)
    case = held_against_jax(comm_runs, n, key, jplan, selftest.SHAPE)
    assert kind in case["step_kinds"]
    # every exchange of a multi-device plan really crossed the ranks
    if kind not in ("ID", "Slice"):
        assert case["p2p_messages"] + case["collectives"] > 0, case
    assert case["staged_bytes"] == 0        # CPU shards: nothing staged


def test_fig9_multi_step_stage_matches_jax_simulator(comm_runs):
    rc = jresolve_comm_ops(selftest.fig9_graph(japi))[1]
    case = held_against_jax(comm_runs, 8, "hetero:fig9/7", rc.plan,
                            tuple(rc.op.inputs[0].shape))
    assert {"RS", "BSR"} <= set(case["step_kinds"])


def test_hsplits_stage_matches_jax_simulator(comm_runs):
    jplan = japi.resolve(*selftest.hsplits_annots(japi), selftest.SHAPE)
    held_against_jax(comm_runs, 4, "hetero:hsplits/4", jplan,
                     selftest.SHAPE)


ROUND_TRIPS = [(n, name) for n in NS for name in selftest.round_trips(n)]


@pytest.mark.parametrize("n,name", ROUND_TRIPS,
                         ids=[r[1] for r in ROUND_TRIPS])
def test_round_trip_matches_jax_simulator(comm_runs, n, name):
    report, out = comm_runs(n)
    key = f"roundtrip:{name}"
    assert report["cases"][key]["ok"], report["cases"][key].get("trace")
    saved = load_case(out, key)
    jsrc, jdst = selftest.round_trips(n, japi)[name]
    there = japi.resolve(jsrc, jdst, selftest.SHAPE)
    want = japply_plan(japi.ShardedTensor(selftest.SHAPE, jsrc,
                                          saved["src"]), there)
    assert_parts_equal(want.parts, saved["mid"], f"{name} there")
    assert_parts_equal(saved["src"], saved["out"], f"{name} back")


@pytest.mark.parametrize("n", NS)
def test_selftest_report_is_whole(comm_runs, n):
    """Every comm case ran and passed at ``n`` ranks, under gloo on the
    CPU, and the report says so."""
    report, _ = comm_runs(n)
    assert report["ok"] and report["ranks"] == n
    assert (report["backend"], report["device"]) == ("gloo", "cpu")
    want = {f"{p}{k}/{n}" for k in selftest.KINDS for p in ("", "int:")}
    want |= {f"roundtrip:{name}" for name in selftest.round_trips(n)}
    want |= {"hetero:hsplits/4"} if n >= 4 else set()
    want |= {"hetero:fig9/7"} if n >= 7 else set()
    assert set(report["cases"]) == want


#: each rank: ``execute_sharded`` on the AG kind case and ``execute_graph``
#: on the ``api:session/2`` program; rank 0 writes their shards
ENTRY_RANK = """
import argparse
import numpy as np
from repro_torch.core.simulator import scatter
from repro_torch.launch.mesh import make_runtime_mesh
from repro_torch.runtime import backend, selftest
ap = argparse.ArgumentParser()
ap.add_argument("--backend"); ap.add_argument("--device")
ap.add_argument("--out")
args = ap.parse_args()
mesh = make_runtime_mesh(backend=args.backend, device=args.device)
src, dst = selftest.kind_cases(2)["AG"]
from repro_torch.core.comm_resolve import resolve
plan = resolve(src, dst, selftest.SHAPE)
value = np.random.default_rng(4).normal(size=selftest.SHAPE).astype(
    np.float32)
got = backend.execute_sharded(scatter(value, src), plan, mesh)
arrays = {f"sharded|x|{d}": p for d, p in got.parts.items()}
compiled = selftest.session_program(2).compile(0)
vals = selftest.session_values()
k = compiled.strategy_index
state = {t.name: scatter(vals[t.name], t.annots[k])
         for t in compiled.graph.tensors.values() if t.name in vals}
out = backend.execute_graph(compiled.graph, k, state=state, mesh=mesh,
                            shape_env=compiled.shape_env,
                            topology=compiled.topology, fetches=["Y"])
arrays.update({f"graph|Y|{d}": p for d, p in out["Y"].parts.items()})
if mesh.rank == 0:
    np.savez(args.out, **arrays)
"""


def test_execute_sharded_and_execute_graph_match_jax_simulator(tmp_path):
    """Two ranks: ``execute_sharded`` (an AG plan) against the JAX
    ``simulator.apply_plan``, and ``execute_graph`` (the ``api:session/2``
    program) against the JAX ``SimulatorExecutor``, bit for bit."""
    out = str(tmp_path / "entry.npz")
    harness.run_ranks(ENTRY_RANK, 2, backend="gloo", device="cpu",
                      timeout=RANK_TIMEOUT, extra_args=["--out", out])
    got: dict = {}
    with np.load(out) as z:
        for k in z.files:
            label, _, dev = k.split("|")
            got.setdefault(label, {})[int(dev)] = z[k]
    jsrc, jdst = selftest.kind_cases(2, japi)["AG"]
    value = np.random.default_rng(4).normal(size=selftest.SHAPE).astype(
        np.float32)
    jplan = japi.resolve(jsrc, jdst, selftest.SHAPE)
    from repro.core.simulator import scatter as jscatter
    want = japply_plan(jscatter(value, jsrc), jplan)
    assert_parts_equal(want.parts, got["sharded"], "execute_sharded")
    vals = selftest.session_values()
    sess = japi.Session(selftest.session_program(2, japi), "pipe",
                        executor=japi.SimulatorExecutor())
    sess.load({"W1": vals["W1"], "W2": vals["W2"]})
    want = sess.run({"X": vals["X"]}).shards("Y")
    assert_parts_equal(want.parts, got["graph"], "execute_graph")


# -- in this process --------------------------------------------------------

def test_nccl_without_a_gpu_per_rank_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs a GPU per rank: 2 ranks"):
        rmesh.make_runtime_mesh(2, backend="nccl", device="cuda")
    # the default backend on the GPU is nccl, and says how to share one
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        rmesh.make_runtime_mesh(2, device="cuda")
    assert rmesh.choose_backend(None, "cuda", 1) == "nccl"
    assert rmesh.choose_backend("gloo", "cuda", 4) == "gloo"
    assert rmesh.choose_backend(None, "cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rmesh.choose_backend("nccl", "cpu", 1)
    with pytest.raises(ValueError, match="unknown backend"):
        rmesh.choose_backend("mpi", "cpu", 1)


def test_gloo_on_a_gpu_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rmesh.make_runtime_mesh(2, backend="gloo", device="cuda")


@pytest.fixture
def world_of_one(tmp_path, monkeypatch):
    """A one-rank gloo world in this process, torn down after the test."""
    for var in ("RANK", "WORLD_SIZE", rmesh.INIT_ENV):
        monkeypatch.delenv(var, raising=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield rmesh.make_runtime_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_plan_wider_than_the_world_raises(world_of_one):
    src, dst = selftest.kind_cases(2)["AG"]
    plan = api.resolve(src, dst, selftest.SHAPE)
    parts = {0: np.zeros((8, 8), np.float32), 1: np.ones((8, 8), np.float32)}
    with pytest.raises(ValueError, match="plan spans 2 logical devices but "
                                         "mesh has only 1 ranks"):
        backend.execute_plan(plan, parts, selftest.SHAPE, world_of_one)
    with pytest.raises(ValueError, match="asked for 2 ranks"):
        rmesh.make_runtime_mesh(2, device="cpu")


def test_world_of_one_runs_a_one_device_plan(world_of_one):
    a = api
    src, dst = a.spmd([0], a.DS({})), a.spmd([0], a.DS({}))
    value = np.arange(128, dtype=np.float32).reshape(selftest.SHAPE)
    fn = backend.resharding_fn(src, dst, world_of_one)
    got = fn({0: value}, selftest.SHAPE)
    np.testing.assert_array_equal(got[0], value)
    assert list(fn.plans) == [selftest.SHAPE]
    assert backend.device_items(fn.plans[selftest.SHAPE].plan, 0)
    assert world_of_one.staged is False and world_of_one.world == 1


def test_rank_env_carries_rank_world_and_rendezvous():
    env = harness.rank_env(3, 4, "file:///tmp/x", base={"PYTHONPATH": "a"})
    assert (env["RANK"], env["WORLD_SIZE"]) == ("3", "4")
    assert "LOCAL_RANK" not in env
    assert env[rmesh.INIT_ENV] == "file:///tmp/x"
    src, rest = env["PYTHONPATH"].split(os.pathsep)
    assert src.endswith(os.path.join("", "src")) and rest == "a"


def test_a_failing_rank_kills_the_others():
    """Rank 1 exits with 3 at once; rank 0 would sleep a minute.  The
    harness raises within seconds, naming rank 1, and rank 0 was
    killed."""
    src = ("import os, sys, time\n"
           "if os.environ['RANK'] == '1':\n"
           "    sys.exit(3)\n"
           "time.sleep(60)\n")
    t0 = time.perf_counter()
    with pytest.raises(harness.RankError, match="rank 1 of 2 exited with "
                                                "code 3") as e:
        harness.run_ranks(src, 2, timeout=50)
    assert time.perf_counter() - t0 < 30
    codes = [p.returncode for p in e.value.outputs]
    assert codes[1] == 3 and codes[0] < 0        # rank 0 killed


def test_a_hung_rank_times_out():
    src = "import time; time.sleep(60)"
    t0 = time.perf_counter()
    with pytest.raises(harness.RankError, match="still running after 2 s"):
        harness.run_ranks(src, 2, timeout=2)
    assert time.perf_counter() - t0 < 20


def test_ranks_get_their_arguments_and_outputs():
    src = ("import os, sys\n"
           "print(os.environ['RANK'], os.environ['WORLD_SIZE'], "
           "*sys.argv[1:])\n")
    procs = harness.run_ranks(src, 3, backend="gloo", device="cpu",
                              timeout=60, extra_args=["--x", "1"])
    assert [p.stdout.split() for p in procs] == [
        [str(r), "3", "--backend", "gloo", "--device", "cpu", "--x", "1"]
        for r in range(3)]


def test_selftest_sweep_stops_at_the_first_failed_case(world_of_one,
                                                       monkeypatch):
    """A case that fails on a rank ends that rank's sweep: later cases'
    collectives would otherwise meet the other ranks out of step."""
    ran = []

    def fake_cases(mesh, n, save):
        def ok():
            ran.append("ok")
            return {}, None

        def bad():
            ran.append("bad")
            raise RuntimeError("boom")

        def later():
            ran.append("later")
            return {}, None
        return {"a": ok, "b": bad, "c": later}
    monkeypatch.setattr(selftest, "comm_cases", fake_cases)
    report = selftest.run_all(world_of_one, groups=("comm",))
    assert ran == ["ok", "bad"]
    assert list(report["cases"]) == ["a", "b"]
    assert not report["ok"] and report["failed_rank"] == 0
    assert "boom" in report["cases"]["b"]["error"]
