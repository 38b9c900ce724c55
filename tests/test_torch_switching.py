"""The port's dynamic graph switching (paper §6) against the JAX package's.

``repro_torch.core.switching.execute_switch(backend="torch")`` runs each
tensor's fused-BSR plan through the torch comm lowering (every virtual
device one row of a stacked buffer, here on the CPU).  BSR moves copies
only, so every destination shard must be bit for bit what the reference's
``execute_switch(backend="sim")`` gives on the same scattered shards, and
the plans' message counts and bytes must be the reference's.  Then
``Session.switch`` on a ``TorchExecutor`` session, with trained AdamW m/v,
against the JAX package's ``SimulatorExecutor`` session.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import annotations as jann  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import switching as jsw  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.core.symbolic import Sym as JSym  # noqa: E402
from repro.core.symbolic import bind_shape  # noqa: E402
from repro.core.topology import NvlinkIbTopology as JTopo  # noqa: E402
from repro.elastic import fixtures as jfix  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import annotations as tann  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import switching as tsw  # noqa: E402
from repro_torch.core.graph import Graph as TGraph  # noqa: E402
from repro_torch.core.symbolic import Sym as TSym  # noqa: E402
from repro_torch.core.topology import NvlinkIbTopology as TTopo  # noqa: E402
from repro_torch.elastic import fixtures as tfix  # noqa: E402

JAX = dict(ann=jann, Graph=JGraph, Sym=JSym)
PORT = dict(ann=tann, Graph=TGraph, Sym=TSym)


def two_strategy_graph(pkg):
    """``tests/test_switching.py``'s graph: TP over devices 0-3, then
    DP-style over devices 4-7."""
    a = pkg["ann"]
    g = pkg["Graph"]()
    x = g.placeholder("X", (8, 16, 32),
                      [a.spmd([0, 1, 2, 3], a.DS({a.DUP: 4})),
                       a.spmd([4, 5, 6, 7], a.DS({0: 4}))])
    w1 = g.parameter("W1", (32, 64), [a.spmd([0, 1, 2, 3], a.DS({1: 4})),
                                      a.spmd([4, 5, 6, 7],
                                             a.DS({a.DUP: 4}))])
    w2 = g.parameter("W2", (64, 32), [a.spmd([0, 1, 2, 3], a.DS({0: 4})),
                                      a.spmd([4, 5, 6, 7],
                                             a.DS({a.DUP: 4}))])
    g.dot(g.gelu(g.dot(x, w1)), w2)
    g.deduce()
    return g, {}


def overlapping_graph(pkg):
    """Device sets that overlap: dst device 0 already owns its rows, so
    the fused plan keeps them local (heuristic I at switch scale)."""
    a = pkg["ann"]
    g = pkg["Graph"]()
    g.parameter("W", (16, 8), [
        a.spmd([0, 1, 2, 3], a.DS({0: 4})),
        a.HSPMD(dgs=[[0, 1], [2]], dss=[a.DS({0: 2}), a.DS({})], hdim=0,
                hsplits=[1, 1])])
    g.deduce()
    return g, {}


def symbolic_graph(pkg):
    """A symbolic leading dim, bound at switch time."""
    a = pkg["ann"]
    g = pkg["Graph"]()
    g.parameter("W", (pkg["Sym"]("B"), 8), [a.spmd([0, 1], a.DS({0: 2})),
                                            a.spmd([2, 3], a.DS({1: 2}))])
    g.deduce()
    return g, {"B": 16}


def shrink_graph(pkg):
    """dp2 x tp2 over 0-3 to tp2 over 0-1: replica 0 keeps its shards."""
    a = pkg["ann"]
    g = pkg["Graph"]()
    g.parameter("W", (12, 16), [
        a.spmd([0, 1, 2, 3], a.DS([(a.DUP, 2), (1, 2)])),
        a.spmd([0, 1], a.DS({1: 2}))])
    g.parameter("b", (16,), [a.spmd([0, 1, 2, 3], a.DS({a.DUP: 4})),
                             a.spmd([0, 1], a.DS({a.DUP: 2}))])
    g.deduce()
    return g, {}


GRAPHS = {"tp_to_dp": (two_strategy_graph, 0, 1),
          "dp_to_tp": (two_strategy_graph, 1, 0),
          "overlapping": (overlapping_graph, 0, 1),
          "symbolic": (symbolic_graph, 0, 1),
          "shrink": (shrink_graph, 0, 1),
          "grow": (shrink_graph, 1, 0)}


def scattered(jg, tg, src, env, seed):
    """The same scattered shards for both packages: the reference's
    ``scatter`` of seeded normal values, re-wrapped under the port's
    annotation (the parts are plain numpy arrays)."""
    rng = np.random.default_rng(seed)
    jw, tw = {}, {}
    for p in jg.parameters():
        shape = bind_shape(p.shape, env)
        value = rng.standard_normal(shape).astype(np.float32)
        st = jsim.scatter(value, p.annots[src])
        jw[p.name] = st
        tw[p.name] = tsim.ShardedTensor(
            st.shape, tg.tensors[p.name].annots[src], dict(st.parts))
    return jw, tw


def assert_shards_equal(want, got, what):
    assert tuple(got.shape) == tuple(want.shape), what
    assert repr(got.annot) == repr(want.annot), what
    assert got.parts.keys() == want.parts.keys(), what
    for dev, arr in want.parts.items():
        assert got.parts[dev].dtype == arr.dtype, (what, dev)
        np.testing.assert_array_equal(got.parts[dev], arr,
                                      err_msg=f"{what} dev {dev}")


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_torch_switch_is_bitwise_the_reference_simulator(case):
    build, src, dst = GRAPHS[case]
    jg, env = build(JAX)
    tg, _ = build(PORT)
    jw, tw = scattered(jg, tg, src, env, seed=len(case))
    jrep = jsw.plan_switch(jg, src, dst, shape_env=env, itemsize=4)
    trep = tsw.plan_switch(tg, src, dst, shape_env=env, itemsize=4)
    assert (trep.message_count, trep.total_bytes) == \
        (jrep.message_count, jrep.total_bytes)
    if case == "shrink":    # the surviving replica keeps every shard
        assert trep.message_count == 0
    want = jsw.execute_switch(jw, jg, src, dst, env, backend="sim")
    got = tsw.execute_switch(tw, tg, src, dst, env, backend="torch",
                             device="cpu", report=trep)
    assert got.keys() == want.keys()
    for name in want:
        assert_shards_equal(want[name], got[name], f"{case} {name}")
    assert set(trep.execute_seconds) == {"lower", "pack", "move", "unpack"}
    # the port's own simulator agrees as well
    sim = tsw.execute_switch(tw, tg, src, dst, env, backend="sim")
    for name in want:
        assert_shards_equal(want[name], sim[name], f"{case} {name} sim")


@pytest.mark.parametrize("mode", ["fused", "unfused", "naive"])
def test_switch_reports_equal_the_reference(mode):
    jg, _ = two_strategy_graph(JAX)
    tg, _ = two_strategy_graph(PORT)
    jrep = jsw.plan_switch(jg, 0, 1, topology=JTopo(), mode=mode)
    trep = tsw.plan_switch(tg, 0, 1, topology=TTopo(), mode=mode)
    assert (trep.message_count, trep.total_bytes) == \
        (jrep.message_count, jrep.total_bytes)
    assert trep.est_transfer_seconds == jrep.est_transfer_seconds
    assert trep.per_sender == jrep.per_sender
    # local retention where the device sets overlap
    tg, _ = overlapping_graph(PORT)
    assert 0 in {a.dst for a in tsw.plan_switch(tg, 0, 1, mode=mode)
                 .plan.local_copies()}


def test_torch_switch_rejects_the_jax_backend():
    tg, _ = two_strategy_graph(PORT)
    _, tw = scattered(two_strategy_graph(JAX)[0], tg, 0, {}, seed=0)
    with pytest.raises(NotImplementedError, match="'torch'"):
        tsw.execute_switch(tw, tg, 0, 1, backend="jax")
    with pytest.raises(ValueError, match="unknown switch backend"):
        tsw.execute_switch(tw, tg, 0, 1, backend="nccl")


def snapshot(sess):
    """Every weight, m and v shard of a session, by name and device."""
    out = dict(sess.weights)
    for key in ("m", "v"):
        out.update({f"{key}/{n}": st
                    for n, st in sess.opt_state[key].items()})
    return out


@pytest.mark.parametrize("dst_kind", ["pp", "hetero", "single"])
def test_session_switch_with_trained_state_matches_the_reference(dst_kind):
    """Two AdamW steps under dp over four devices, a switch, one more
    step: a ``TorchExecutor(cpu)`` session of the port against the JAX
    package's ``SimulatorExecutor`` session, every shard bitwise, and the
    flat-buffer AdamW cache rebuilt after the switch."""
    sessions = {}
    for name, pkg, ex in (("ref", japi, japi.SimulatorExecutor()),
                          ("port", tapi, tapi.TorchExecutor("cpu"))):
        fix = jfix if pkg is japi else tfix
        prog = pkg.Program(fix.probe_graph(),
                           [fix.probe_layout([0, 1, 2, 3], "dp")])
        sess = pkg.Session(prog, 0, executor=ex)
        sess.load(fix.probe_values())
        for step in range(2):
            sess.train_step(fix.probe_feeds(step))
        flat = sess.opt_state["_flat"]["P"]
        report = sess.switch(fix.probe_layout([0, 1, 2, 3], dst_kind))
        sessions[name] = (sess, report, flat)
    (ref, jrep, _), (port, trep, flat) = sessions["ref"], sessions["port"]
    assert (trep.src_name, trep.dst_name) == (jrep.src_name, jrep.dst_name)
    assert (trep.message_count, trep.total_bytes) == \
        (jrep.message_count, jrep.total_bytes)
    assert trep.execute_seconds["move"] >= 0  # went through the lowering
    want, got = snapshot(ref), snapshot(port)
    for key in want:
        assert_shards_equal(want[key], got[key], key)
    for sess, fix in ((ref, jfix), (port, tfix)):
        sess.train_step(fix.probe_feeds(2))
    assert port.opt_state["_flat"]["P"] is not flat   # rebuilt, not reused
    want, got = snapshot(ref), snapshot(port)
    for key in want:
        assert_shards_equal(want[key], got[key], f"after a step: {key}")
