"""The port's copy of the planning half against the JAX package's.

``repro_torch`` keeps its own copies of ``repro.core``, ``repro.api``,
``repro.models.graph_block`` and the numpy half of ``repro.optim.adamw``.
Here the same programs are built through both packages and every planning
result is held equal: the deduced annotations, the resolved comm plans
(steps, kinds, groups), the per-device ExecItems, the pipeline ticks and
the cost summary; then both ``SimulatorExecutor``s run them, and their
outputs and ``train_step`` gradients must agree bit for bit.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.api import testing as jtesting  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import graph_block as jblock  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.api import testing as ttesting  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.models import graph_block as tblock  # noqa: E402

JAX = dict(api=japi, testing=jtesting, config=jget_config, block=jblock)
PORT = dict(api=tapi, testing=ttesting, config=tget_config, block=tblock)

BLOCKS = {"qwen2_dp2tp2": ("qwen2_1_5b", dict(dp=2, tp=2, pp=1)),
          "llama_tp2pp2": ("llama_32b", dict(dp=1, tp=2, pp=2))}
PROGRAMS = list(BLOCKS) + ["hetero", "zigzag", "pipe2", "pipe4", "pipe8"]
B, S = 2, 8


def build(pkg, name):
    if name in BLOCKS:
        arch, par = BLOCKS[name]
        cfg = pkg["config"](arch).reduced()
        return pkg["block"].block_program(cfg, batch=B, seq=S, **par)
    if name == "hetero":
        return pkg["testing"].hetero_program()
    if name == "zigzag":
        return pkg["testing"].zigzag_program(4)
    return pkg["testing"].loss_pipeline_program(int(name[4:]))


def feeds_and_weights(prog, name):
    """Numpy leaves, drawn as ``tests/test_archs.py`` and the selftest
    fixtures draw them."""
    rng = np.random.default_rng(0)
    if name in BLOCKS:
        vocab = prog.graph.tensors["embed"].shape[0]
        feeds = {"ids": rng.integers(0, vocab, (B, S)).astype(np.int32),
                 "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
        ws = {t.name: np.ones(t.shape, np.float32)
              if "norm" in t.name.split("/")[-1]
              else (rng.standard_normal(t.shape) * 0.05).astype(np.float32)
              for t in prog.graph.parameters()}
        return feeds, ws
    if name == "hetero":
        xv, ws, _, _ = jtesting.hetero_values(seed=7)
    elif name == "zigzag":
        xv, ws, _ = jtesting.zigzag_values(seed=13)
    else:
        xv, ws, _ = jtesting.loss_pipeline_values(seed=11)
    return {"X": xv}, ws


def plan_record(plan):
    """Everything a compiled (train) plan decided, in comparable form."""
    g, k = plan.graph, plan.strategy_index
    annots = {n: repr(t.annots[k]) for n, t in g.tensors.items()
              if t.annots}
    comms = [(rc.op.outputs[0].name, rc.plan.kind,
              [(st.kind, [(grp.box, tuple(grp.srcs), tuple(grp.dsts),
                           grp.reduce) for grp in st.groups])
               for st in rc.plan.steps])
             for rc in plan.specialization.resolved]
    items = {d: [(i.kind, i.name, i.role, i.detail, i.phase)
                 for i in plan.exec_items(d)] for d in plan.devices}
    return dict(annots=annots, comms=comms, items=items,
                shapes=plan.shapes, cost=plan.cost.summary(),
                n_stages=plan.n_stages,
                v=plan.virtual_stages_per_device)


def ticks(prog, name, m=2):
    kind = "interleaved" if name == "zigzag" else "1f1b"
    mplan = prog.compile_micro(0, m)
    return [(t.slot, t.stage, t.microbatch, t.phase)
            for t in mplan.schedule(m, kind).ticks]


@pytest.mark.parametrize("name", PROGRAMS)
def test_compile_results_equal_the_reference(name):
    jprog, tprog = build(JAX, name), build(PORT, name)
    for train in (False, True):
        compile_ = "compile_train" if train else "compile"
        jrec = plan_record(getattr(jprog, compile_)(0))
        trec = plan_record(getattr(tprog, compile_)(0))
        assert trec.keys() == jrec.keys()
        for key in jrec:
            assert trec[key] == jrec[key], (name, compile_, key)
    try:
        want = ticks(jprog, name)
    except japi.MicrobatchError as e:    # the qkv bias cannot microbatch
        with pytest.raises(tapi.MicrobatchError) as got:
            ticks(tprog, name)
        assert str(got.value) == str(e)
    else:
        assert ticks(tprog, name) == want


def assert_shards_equal(a, b, what):
    assert a.shape == b.shape and repr(a.annot) == repr(b.annot), what
    assert a.parts.keys() == b.parts.keys(), what
    for dev in a.parts:
        np.testing.assert_array_equal(b.parts[dev], a.parts[dev],
                                      err_msg=f"{what} dev {dev}")
        assert b.parts[dev].dtype == a.parts[dev].dtype, (what, dev)


@pytest.mark.parametrize("name", PROGRAMS)
def test_simulator_runs_and_train_steps_equal_the_reference(name):
    jprog, tprog = build(JAX, name), build(PORT, name)
    feeds, ws = feeds_and_weights(jprog, name)
    sessions = []
    for api, prog in ((japi, jprog), (tapi, tprog)):
        sess = api.Session(prog, 0, executor=api.SimulatorExecutor())
        sess.load(ws)
        sessions.append(sess)
    jrun, trun = (s.run(dict(feeds)) for s in sessions)
    for f in jrun.outputs:
        assert_shards_equal(jrun.outputs[f], trun.outputs[f], f"run {f}")
    for step in range(2):
        jr, tr = (s.train_step(dict(feeds)) for s in sessions)
        assert tr.loss == jr.loss, (name, step)
        assert tr.metrics == jr.metrics, (name, step)
        for p in ws:
            assert_shards_equal(jr.grads[p], tr.grads[p], f"grad {p}")
            assert_shards_equal(sessions[0].weights[p],
                                sessions[1].weights[p], f"weight {p}")
