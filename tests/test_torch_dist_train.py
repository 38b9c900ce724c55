"""Graphs, sessions and switches across ranks on the CPU:
``runtime.dist_program``, ``api.DistExecutor`` and
``core.switching.execute_switch(backend="dist")`` against the JAX
package.

The port's selftest (``--cases api``) runs as 2 and 4 ranks under
``gloo`` (``run_ranks``); each rank checks ``DistExecutor`` against the
port's ``SimulatorExecutor`` bit for bit, and rank 0 writes every run's
inputs and output shards.  This process holds them against the JAX
package's ``SimulatorExecutor`` on the same inputs, bit for bit (integer-
valued data): ``api:session``, ``api:pipeline`` (every m and schedule),
``api:pipeline/interleaved``, ``api:train`` (losses, gradient and weight
shards), and the switch migration against the JAX simulator's.  Then a
reduced Qwen2 ``block_program`` under dp2×tp2 trains two steps on 4 ranks
against the JAX ``SimulatorExecutor`` at phase 5's tolerance (loss rtol
1e-5, gradients and weights atol 1e-6 / rtol 2e-4).
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.api import testing as jtesting  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.switching import execute_switch as jexecute_switch  # noqa: E402
from repro.models.graph_block import block_program as jblock  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.launch import mesh as rmesh  # noqa: E402
from repro_torch.runtime import harness, selftest  # noqa: E402

NS = (2, 4)
RANK_TIMEOUT = 150.0


def load_case(out_dir, key):
    """``{label: {tensor: {dev: array}}}`` of one case's saved arrays."""
    got: dict = {}
    with np.load(os.path.join(out_dir,
                              selftest.safe_name(key) + ".npz")) as z:
        for k in z.files:
            label, name, dev = k.split("|")
            got.setdefault(label, {}).setdefault(name, {})[int(dev)] = z[k]
    return got


@pytest.fixture(scope="module")
def api_runs(tmp_path_factory):
    """``n -> (report, out dir)`` of the api selftest at ``n`` ranks."""
    runs = {}

    def get(n):
        if n not in runs:
            out = tmp_path_factory.mktemp(f"api{n}")
            procs = harness.run_ranks(
                "repro_torch.runtime.selftest", n, backend="gloo",
                device="cpu", timeout=RANK_TIMEOUT,
                extra_args=["--cases", "api", "--out", str(out)])
            line = next(x for x in procs[0].stdout.splitlines()
                        if x.startswith("RUNTIME_SELFTEST_JSON "))
            runs[n] = (json.loads(line.split(" ", 1)[1]), str(out))
        return runs[n]
    return get


def case_of(api_runs, n, key):
    report, out = api_runs(n)
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


def inputs(saved):
    return {name: parts[0] for name, parts in saved["in"].items()}


@pytest.mark.parametrize("n", NS)
def test_session_run_matches_jax_simulator(api_runs, n):
    case, saved = case_of(api_runs, n, f"api:session/{n}")
    vals = inputs(saved)
    sess = japi.Session(selftest.session_program(n, japi), "pipe",
                        executor=japi.SimulatorExecutor())
    sess.load({"W1": vals["W1"], "W2": vals["W2"]})
    assert_shards(sess.run({"X": vals["X"]}).shards("Y"), saved["run"]["Y"],
                  f"session/{n}")
    assert case["p2p_messages"] > 0       # H -> H2 crossed the stages


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("interleaved", [False, True],
                         ids=["pipeline", "interleaved"])
def test_pipeline_runs_match_jax_simulator(api_runs, n, interleaved):
    if interleaved:
        key, label = f"api:pipeline/interleaved{n}", "zig"
        prog = jtesting.zigzag_program(n, name="zig")
        runs = [(m, "interleaved") for m in (1, 2, 4)]
    else:
        key, label = f"api:pipeline/{n}", "pipe"
        prog = jtesting.loss_pipeline_program(n, name="pipe")
        runs = selftest.PIPE_RUNS
    _, saved = case_of(api_runs, n, key)
    vals = inputs(saved)
    sess = japi.Session(prog, label, executor=japi.SimulatorExecutor())
    sess.load({k: v for k, v in vals.items() if k != "X"})
    for m, kind in runs:
        r = sess.run({"X": vals["X"]}, fetches=["Y", "L"],
                     num_microbatches=m, schedule=kind)
        for t in ("Y", "L"):
            assert_shards(r.shards(t), saved[f"m{m}-{kind}"][t],
                          f"{key} {t} m={m} {kind}")


@pytest.mark.parametrize("n", NS)
def test_train_steps_match_jax_simulator(api_runs, n):
    _, saved = case_of(api_runs, n, f"api:train/{n}")
    vals = inputs(saved)
    ws = {k: v for k, v in vals.items() if k != "X"}
    for m, kind in selftest.TRAIN_RUNS:
        sess = japi.Session(jtesting.loss_pipeline_program(n, name="pipe"),
                            "pipe", executor=japi.SimulatorExecutor())
        sess.load(ws)
        r = sess.train_step({"X": vals["X"]}, num_microbatches=m,
                            schedule=kind)
        assert float(saved[f"m{m}-{kind}-loss"]["L"][0]) == r.loss
        for w in ws:
            assert_shards(r.grads[w], saved[f"m{m}-{kind}-grad"][w],
                          f"grad {w} m={m} {kind}")
            assert_shards(sess.weights[w], saved[f"m{m}-{kind}-weight"][w],
                          f"weight {w} m={m} {kind}")


@pytest.mark.parametrize("n", NS)
def test_switch_matches_jax_simulator_migration(api_runs, n):
    _, saved = case_of(api_runs, n, f"switch:dist/{n}")
    g = selftest.switch_graph(n, japi)
    weights = {name: japi.ShardedTensor(tuple(g.tensors[name].shape),
                                        g.tensors[name].annots[0], parts)
               for name, parts in saved["src"].items()}
    assert set(weights) == {"W1", "W2"}
    want = jexecute_switch(weights, g, 0, 1, backend="sim")
    for name in weights:
        assert_shards(want[name], saved["dst"][name], f"switch {name}")
        for dev, arr in weights[name].parts.items():
            np.testing.assert_array_equal(saved["back"][name][dev], arr)


@pytest.mark.parametrize("n", NS)
def test_api_report_is_whole(api_runs, n):
    report, _ = api_runs(n)
    assert report["ok"] and report["ranks"] == n
    assert set(report["cases"]) == {
        f"api:session/{n}", f"api:pipeline/{n}",
        f"api:pipeline/interleaved{n}", f"api:train/{n}",
        f"switch:dist/{n}"}


# -- a reduced Qwen2 block under dp2 x tp2 on 4 ranks -----------------------

B, S, STEPS = 2, 128, 2

#: each rank: the test's weights from seed 0, two train steps on
#: DistExecutor; rank 0 writes the losses, gradients and weights
BLOCK_RANK = """
import argparse, sys
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
cfg = get_config("qwen2_1_5b").reduced()
rng = np.random.default_rng(0)
feeds = {"ids": rng.integers(0, cfg.vocab, (%(B)d, %(S)d)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (%(B)d, %(S)d)).astype(np.int32)}
prog = block_program(cfg, batch=%(B)d, seq=%(S)d, dp=2, tp=2, pp=1)
ws = {t.name: np.ones(t.shape, np.float32)
      if "norm" in t.name.split("/")[-1]
      else (rng.standard_normal(t.shape) * 0.05).astype(np.float32)
      for t in prog.graph.parameters()}
ex = api.DistExecutor(mesh)
sess = api.Session(prog, 0, executor=ex)
sess.load(ws)
arrays = {}
for step in range(%(STEPS)d):
    r = sess.train_step(dict(feeds))
    arrays[f"loss{step}"] = np.float64(r.loss)
    for n in ws:
        arrays[f"grad{step}|{n}"] = r.grad_value(n)
        arrays[f"weight{step}|{n}"] = sess.weight_value(n)
tplan = prog.compile_train(0)
stats = ex.lowered(tplan, [tplan.loss_name] + [
    tplan.grad_map[t.name] for t in tplan.graph.parameters()]).stats
arrays["dispatches"] = np.array([stats.ref_dispatches,
                                 stats.kernel_dispatches])
if mesh.rank == 0:
    np.savez(args.out, **arrays)
""" % dict(B=B, S=S, STEPS=STEPS)


def test_qwen2_block_trains_on_four_ranks_like_the_jax_simulator(tmp_path):
    out = str(tmp_path / "block.npz")
    harness.run_ranks(BLOCK_RANK, 4, backend="gloo", device="cpu",
                      timeout=RANK_TIMEOUT, extra_args=["--out", out])
    got = np.load(out)
    cfg = jget_config("qwen2_1_5b").reduced()
    rng = np.random.default_rng(0)
    feeds = {"ids": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    prog = jblock(cfg, batch=B, seq=S, dp=2, tp=2, pp=1)
    ws = {t.name: np.ones(t.shape, np.float32)
          if "norm" in t.name.split("/")[-1]
          else (rng.standard_normal(t.shape) * 0.05).astype(np.float32)
          for t in prog.graph.parameters()}
    ref = japi.Session(prog, 0, executor=japi.SimulatorExecutor())
    ref.load(ws)
    for step in range(STEPS):
        want = ref.train_step(dict(feeds))
        np.testing.assert_allclose(float(got[f"loss{step}"]), want.loss,
                                   rtol=1e-5, atol=1e-9)
        for n in ws:
            np.testing.assert_allclose(
                got[f"grad{step}|{n}"], want.grad_value(n), atol=1e-6,
                rtol=2e-4, err_msg=f"step {step} grad {n}")
            np.testing.assert_allclose(
                got[f"weight{step}|{n}"], ref.weight_value(n), atol=1e-6,
                rtol=2e-4, err_msg=f"step {step} weight {n}")
    # each rank runs one attention class a layer, on the plain version on
    # the CPU
    assert list(got["dispatches"]) == [cfg.n_layers, 0]


# -- in this process --------------------------------------------------------

def test_dist_executor_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.DistExecutor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.get_executor("dist")


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


def test_get_executor_dist_runs_a_one_device_session(world_of_one):
    """``get_executor("dist", device="cpu")`` over a one-rank world: a
    one-device program against the simulator, bit for bit; a program
    wider than the world raises."""
    ex = api.get_executor("dist", device="cpu")
    assert isinstance(ex, api.DistExecutor) and ex.name == "dist"
    assert isinstance(ex, api.Executor) and ex.device.type == "cpu"
    g = api.Graph()
    g.placeholder("X", (4, 8))
    g.parameter("W", (8, 3))
    g.relu(g.dot(g.tensors["X"], g.tensors["W"]), name="Y")
    one = api.Program(g, [api.Strategy("one", {
        "X": api.spmd([0], api.DS({})), "W": api.spmd([0], api.DS({}))})])
    rng = np.random.default_rng(0)
    xv = rng.integers(-4, 5, (4, 8)).astype(np.float32)
    wv = rng.integers(-4, 5, (8, 3)).astype(np.float32)
    outs = {}
    for e in (api.SimulatorExecutor(), ex):
        sess = api.Session(one, "one", executor=e)
        sess.load({"W": wv})
        outs[e.name] = sess.run({"X": xv}).shards("Y")
    np.testing.assert_array_equal(outs["dist"].parts[0],
                                  outs["sim"].parts[0])
    sess = api.Session(selftest.session_program(2), "pipe", executor=ex)
    vals = selftest.session_values()
    sess.load({"W1": vals["W1"], "W2": vals["W2"]})
    with pytest.raises(ValueError, match="spans 2 logical devices"):
        sess.run({"X": vals["X"]})
