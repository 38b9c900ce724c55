"""The port's elastic trace driver against the JAX package's oracle.

``tests/test_elastic.py``'s cases, each run on the port's numpy
``SimulatorExecutor`` and on ``TorchExecutor(device="cpu")`` (where every
switch migrates weights and AdamW m/v through the torch comm lowering).
The oracle is the JAX package's ``fixtures.reference_run`` on its
``SimulatorExecutor``: the probe's weight gradients are
weight-independent integers, so any elastic trajectory's weights, m and v
must be bitwise the uninterrupted run's; losses agree to rtol 1e-5.  Then
the ``elastic:trace/*`` traces of ``repro.runtime.selftest``, and a
checkpoint written by one package and resumed by the other.
"""

import functools
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.elastic import ElasticDriver as JDriver  # noqa: E402
from repro.elastic import Fault as JFault  # noqa: E402
from repro.elastic import FaultPlan as JFaultPlan  # noqa: E402
from repro.core.simulator import gather as jgather  # noqa: E402
from repro.elastic import fixtures as jfix  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core.simulator import gather  # noqa: E402
from repro_torch.elastic import (ElasticDriver, ElasticError, Fault,  # noqa: E402
                                 FaultError, FaultPlan, TraceEvent, inject,
                                 latest_checkpoint)
from repro_torch.elastic.fixtures import (SearchProvider, probe_feeds,  # noqa: E402
                                          probe_graph, probe_layout,
                                          probe_provider, probe_values,
                                          reference_run)

EXECUTORS = {"sim": api.SimulatorExecutor,
             "torch": lambda: api.TorchExecutor("cpu")}


def snap(session, gather=gather):
    """Gathered full weights + optimizer m/v (the bitwise-compared
    state); ``gather`` is the session's package's."""
    out = {n: gather(st) for n, st in session.weights.items()}
    for key in ("m", "v"):
        for n, st in session.opt_state[key].items():
            out[f"{key}/{n}"] = gather(st)
    return out


@functools.lru_cache(maxsize=None)
def oracle(n_steps, m=1):
    """The JAX package's uninterrupted dp run on its SimulatorExecutor:
    (gathered state, losses)."""
    ref, losses = jfix.reference_run(jfix.probe_layout([0, 1, 2, 3], "dp"),
                                     n_steps, num_microbatches=m)
    return snap(ref, jgather), tuple(losses)


def assert_matches_reference(session, losses, n_steps, m=1):
    want, ref_losses = oracle(n_steps, m)
    got = snap(session)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(
            got[key], want[key],
            err_msg=f"{key} drifted from the uninterrupted reference")
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)


def make_driver(ex="sim", **kw):
    kw.setdefault("num_microbatches", 1)
    return ElasticDriver(probe_graph(), probe_values(),
                         kw.pop("provider", probe_provider()),
                         probe_feeds, executor=EXECUTORS[ex](), **kw)


# -- per-transition-kind differential oracles -------------------------------

TRANSITION_TRACES = {
    "shrink": [(0, (0, 1, 2, 3), "dp"), (3, (0, 1), "dp")],
    "grow": [(0, (0, 1), "dp"), (3, (0, 1, 2, 3), "dp")],
    "class-change": [(0, (0, 1, 2, 3), "dp"), (3, (0, 1, 2, 3), "pp")],
    "no-op": [(0, (0, 1, 2, 3), "dp"), (3, (0, 1, 2, 3), "dp")],
}


@pytest.mark.parametrize("ex", sorted(EXECUTORS))
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("kind", sorted(TRANSITION_TRACES))
def test_transition_kind_differential(kind, m, ex):
    n_steps = 6
    driver = make_driver(ex, num_microbatches=m)
    run = driver.run([TraceEvent(*e) for e in TRANSITION_TRACES[kind]],
                     n_steps)
    assert run.transition_kinds() == [kind], run.summary()
    assert len(run.steps) == n_steps
    assert_matches_reference(driver.session, run.losses, n_steps, m=m)


@pytest.mark.parametrize("ex", sorted(EXECUTORS))
def test_transition_reports_consumed(ex):
    driver = make_driver(ex)
    run = driver.run([(0, (0, 1), "dp"), (2, (0, 1, 2, 3), "pp")], 4)
    (t,) = run.transitions
    assert t.kind == "grow" and t.trigger == "trace"
    assert t.report.src_name == "dp[0,1]"
    assert t.report.dst_name == "pp[0,1,2,3]"
    assert t.report.wall_seconds > 0
    assert t.select_seconds >= 0
    assert t.report.message_count >= 1  # W2 really moved to new devices
    assert "pp[0,1,2,3]" in t.describe()
    # the torch session migrated on the lowering; the simulator's did not
    assert ("move" in t.report.execute_seconds) == (ex == "torch")


@pytest.mark.parametrize("ex", sorted(EXECUTORS))
def test_three_transition_trace_with_search_provider(ex):
    n_steps = 8
    provider = SearchProvider(max_rank=4)
    driver = make_driver(ex, provider=provider, num_microbatches=2)
    trace = [(0, (0, 1, 2, 3)), (2, (0, 1)), (4, (0, 1, 2, 3)),
             (6, (0, 1, 2, 3), "hetero")]
    run = driver.run(trace, n_steps)
    assert run.transition_kinds() == ["shrink", "grow", "class-change"]
    assert len(provider.selections) >= 3
    assert all(s.predicted_step_s > 0 for s in provider.selections)
    assert_matches_reference(driver.session, run.losses, n_steps, m=2)


@pytest.mark.parametrize("ex", sorted(EXECUTORS))
def test_fault_kill_join_and_mid_transition(ex):
    n_steps = 6
    faults = FaultPlan((
        Fault(2, "kill", (2, 3)),
        Fault(4, "join", (2,)),
        Fault(4, "kill", (2,), phase="mid-transition"),
    ))
    driver = make_driver(ex, faults=faults)
    run = driver.run([(0, (0, 1, 2, 3), "dp")], n_steps)
    kinds = {(t.step, t.trigger): t.kind for t in run.transitions}
    assert kinds[(2, "fault")] == "shrink"
    assert kinds[(4, "fault")] == "grow"
    assert kinds[(4, "mid-transition")] == "shrink"
    assert_matches_reference(driver.session, run.losses, n_steps)
    effective = inject([(0, (0, 1, 2, 3))], faults, n_steps)
    assert [s.ranks for s in run.steps] == \
        [effective[s] for s in range(n_steps)]


@pytest.mark.parametrize("ex", sorted(EXECUTORS))
def test_checkpoint_kill_resume_under_different_topology(ex, tmp_path):
    n_steps = 8
    faults = FaultPlan((Fault(4, "crash", phase="post-checkpoint"),))
    driver = make_driver(ex, checkpoint_every=2,
                         ckpt_dir=str(tmp_path / "ck"), faults=faults)
    trace = [(0, (0, 1, 2, 3), "dp")]
    run = driver.run(trace, n_steps)
    assert run.interrupted_at == 4
    assert [s for s, _ in run.checkpoints] == [2, 4]
    run2 = driver.resume(trace, n_steps, ranks=(4, 5), layout="pp")
    assert run2.resumed_from[0] == 4
    assert [s.step for s in run2.steps] == [4, 5, 6, 7]
    assert run2.steps[0].ranks == (4, 5)
    assert_matches_reference(driver.session, run.losses + run2.losses,
                             n_steps)


@pytest.mark.parametrize("ex", sorted(EXECUTORS))
def test_resume_replays_lost_progress_deterministically(ex, tmp_path):
    n_steps = 9
    driver = make_driver(ex, checkpoint_every=3,
                         ckpt_dir=str(tmp_path / "lost"))
    trace = [(0, (0, 1, 2, 3), "dp")]
    run = driver.run(trace, 8)
    assert [s for s, _ in run.checkpoints] == [3, 6]
    run2 = driver.resume(trace, n_steps, ranks=(0, 1), layout="dp")
    assert [s.step for s in run2.steps] == [6, 7, 8]
    assert_matches_reference(driver.session, run.losses[:6] + run2.losses,
                             n_steps)


@pytest.mark.parametrize("ex", sorted(EXECUTORS))
def test_resume_without_checkpoint_raises(ex, tmp_path):
    driver = make_driver(ex, checkpoint_every=2,
                         ckpt_dir=str(tmp_path / "none"))
    with pytest.raises(ElasticError, match="no complete checkpoint"):
        driver.resume([(0, (0, 1))], 4)


@pytest.mark.parametrize("ex", sorted(EXECUTORS))
def test_trace_must_cover_step_zero(ex):
    with pytest.raises(ElasticError, match="step 0"):
        make_driver(ex).run([(2, (0, 1))], 4)


def test_fault_validation():
    with pytest.raises(FaultError, match="kind"):
        Fault(0, "explode", (1,))
    with pytest.raises(FaultError, match="post-checkpoint"):
        Fault(0, "crash", phase="pre-step")
    with pytest.raises(FaultError, match="ranks"):
        Fault(0, "kill")
    with pytest.raises(FaultError, match="alive"):
        inject([(0, (0,))], FaultPlan((Fault(1, "kill", (0,)),)), 3)


@pytest.mark.parametrize("ex", sorted(EXECUTORS))
def test_switch_trips_flat_adamw_fallback(ex):
    """A switch migrates m/v to fresh arrays, so the next step rebuilds
    the flat AdamW buffer instead of reusing stale views, and stays
    bitwise on the reference."""
    program = api.Program(probe_graph(), [probe_layout([0, 1, 2, 3])])
    session = api.Session(program, 0, executor=EXECUTORS[ex]())
    session.load(probe_values())
    session.train_step(probe_feeds(0))
    session.train_step(probe_feeds(1))
    f1 = session.opt_state["_flat"]["P"]
    session.train_step(probe_feeds(2))
    assert session.opt_state["_flat"]["P"] is f1  # steady-state reuse
    session.switch(probe_layout([0, 1], "dp"))
    assert session.opt_state.get("_flat") is not None  # stale cache kept
    session.train_step(probe_feeds(3))
    assert session.opt_state["_flat"]["P"] is not f1  # rebuilt
    want, _ = oracle(4)
    got = snap(session)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_save_atomic_under_mid_save_fault(tmp_path, monkeypatch):
    """A fault mid-save never leaves a half-checkpoint that
    ``latest_checkpoint`` or ``resume`` can pick up; the previous complete
    checkpoint at the same path survives."""
    ckdir = str(tmp_path / "cks")
    path = os.path.join(ckdir, "step-000002")
    store.save(path, {"weights": {"W1": np.arange(4.0, dtype=np.float32)}},
               step=2)

    class Boom(RuntimeError):
        pass

    def exploding_savez(*a, **kw):
        raise Boom("disk died mid-save")

    monkeypatch.setattr(store.np, "savez", exploding_savez)
    with pytest.raises(Boom):
        store.save(path, {"weights": {"W1": np.full(4, 9.0)}}, step=9)
    monkeypatch.undo()
    found = latest_checkpoint(ckdir)
    assert found is not None and found[1]["step"] == 2
    import torch
    restored, step = store.restore(
        path, {"weights": {"W1": torch.zeros(4)}})
    assert step == 2
    np.testing.assert_array_equal(restored["weights"]["W1"].numpy(),
                                  np.arange(4.0, dtype=np.float32))
    assert [d for d in os.listdir(ckdir) if d.startswith("step-")] == \
        ["step-000002"]


def test_save_crash_after_arrays_before_manifest(tmp_path, monkeypatch):
    ckdir = str(tmp_path / "cks")

    def exploding_dump(*a, **kw):
        raise KeyboardInterrupt

    monkeypatch.setattr(store.json, "dump", exploding_dump)
    with pytest.raises(KeyboardInterrupt):
        store.save(os.path.join(ckdir, "step-000004"),
                   {"weights": {"W1": np.ones(2)}}, step=4)
    monkeypatch.undo()
    assert latest_checkpoint(ckdir) is None


# -- property: random traces never corrupt optimizer state ------------------

LAYOUT_OPTIONS = ("dp", "pp", "hetero", None)


def _random_faulted_trace(seed: int):
    """``tests/test_elastic.py``'s generator: a random trace + FaultPlan
    over the 4-device pool, m in {1, 2, 4}."""
    rng = np.random.default_rng(seed)

    def pick(seq):
        return seq[int(rng.integers(len(seq)))]

    def rank_set(min_size=1, max_size=4):
        k = int(rng.integers(min_size, max_size + 1))
        return tuple(sorted(rng.choice(4, size=k, replace=False)
                            .astype(int).tolist()))

    n_steps = int(rng.integers(4, 9))
    events = [TraceEvent(0, (0, 1, 2, 3), pick(LAYOUT_OPTIONS))]
    for step in sorted(set(rng.integers(1, n_steps,
                                        size=int(rng.integers(0, 4)))
                           .astype(int).tolist())):
        events.append(TraceEvent(step, rank_set(), pick(LAYOUT_OPTIONS)))
    faults = []
    for step in sorted(set(rng.integers(1, n_steps,
                                        size=int(rng.integers(0, 3)))
                           .astype(int).tolist())):
        faults.append(Fault(step, pick(("kill", "join")),
                            rank_set(max_size=2),
                            phase=pick(("pre-step", "mid-transition"))))
    m = pick((1, 2, 4))
    return events, FaultPlan(tuple(faults)), n_steps, m


@pytest.mark.parametrize("ex", sorted(EXECUTORS))
@pytest.mark.parametrize("seed", range(6))
def test_random_traces_never_corrupt_optimizer_state(seed, ex):
    events, faults, n_steps, m = _random_faulted_trace(seed)
    try:
        effective = inject(events, faults, n_steps)
    except FaultError:
        return  # the plan killed every device: nothing to run
    driver = make_driver(ex, num_microbatches=m, faults=faults)
    run = driver.run(events, n_steps)
    assert [s.ranks for s in run.steps] == \
        [effective[s] for s in range(n_steps)]
    assert_matches_reference(driver.session, run.losses, n_steps, m=m)


# -- the runtime selftest's elastic traces, on TorchExecutor ---------------

SELFTEST_TRACES = {
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


@pytest.mark.parametrize("key", sorted(SELFTEST_TRACES))
def test_selftest_elastic_trace_on_torch(key):
    """``repro.runtime.selftest``'s ``elastic:trace/*`` cases (6 steps,
    m=2) on ``TorchExecutor(cpu)``: bitwise the JAX package's reference
    run, and the transition kinds the selftest expects."""
    trace, kinds = SELFTEST_TRACES[key]
    driver = make_driver("torch", num_microbatches=2)
    run = driver.run([TraceEvent(*e) for e in trace], 6)
    assert run.transition_kinds() == kinds
    assert_matches_reference(driver.session, run.losses, 6, m=2)
    # the port's own oracle, as chip_smoke.py runs it, agrees bit for bit
    ref, _ = reference_run(probe_layout([0, 1, 2, 3], "dp"), 6,
                           executor=api.SimulatorExecutor(),
                           num_microbatches=2)
    want = snap(ref)
    for k, v in snap(driver.session).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# -- checkpoints across the packages ---------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_written_by_one_package_resumes_in_the_other(writer,
                                                                 tmp_path):
    """A crash after step 4's checkpoint; the OTHER package's driver
    resumes from it on two other devices under the pipelined layout and
    ends bitwise on the reference."""
    n_steps, ck = 8, str(tmp_path / "x")
    trace = [(0, (0, 1, 2, 3), "dp")]
    if writer == "jax":
        first = JDriver(jfix.probe_graph(), jfix.probe_values(),
                        jfix.probe_provider(), jfix.probe_feeds,
                        checkpoint_every=2, ckpt_dir=ck,
                        faults=JFaultPlan((JFault(4, "crash",
                                                  phase="post-checkpoint"),)))
        resumer = make_driver("torch", checkpoint_every=2, ckpt_dir=ck)
    else:
        first = make_driver("torch", checkpoint_every=2, ckpt_dir=ck,
                            faults=FaultPlan((Fault(4, "crash",
                                                    phase="post-checkpoint"),)))
        resumer = JDriver(jfix.probe_graph(), jfix.probe_values(),
                          jfix.probe_provider(), jfix.probe_feeds,
                          checkpoint_every=2, ckpt_dir=ck)
    run = first.run(trace, n_steps)
    assert run.interrupted_at == 4
    run2 = resumer.resume(trace, n_steps, ranks=(4, 5), layout="pp")
    assert [s.step for s in run2.steps] == [4, 5, 6, 7]
    want, ref_losses = oracle(n_steps)
    got = snap(resumer.session, jgather if writer == "port" else gather)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(run.losses + run2.losses, ref_losses,
                               rtol=1e-5)


def test_driver_and_validator_default_to_cuda(monkeypatch):
    """Given no executor the driver's sessions run on ``TorchExecutor()``
    (``cuda``), as does the validator's ``"torch"`` executor given no
    device: with no GPU both raise, never moving to the CPU on their
    own."""
    import torch

    from repro_torch import search
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    driver = ElasticDriver(probe_graph(), probe_values(), probe_provider(),
                           probe_feeds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.run([(0, (0, 1))], 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.search(search.cpu_cluster(2), search.tiny_spec(),
                      global_batch=8, seq_len=128, validate_top=1,
                      repeats=1, executors=("sim", "torch"))
