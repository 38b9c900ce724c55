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
* ``api`` cases: ``api:session/n``, ``api:pipeline/n``,
  ``api:pipeline/interleavedn`` and ``api:train/n`` through
  ``api.DistExecutor``, and ``switch:dist/n``, the fused-BSR weight
  migration through ``core.switching.execute_switch(backend="dist")``.

With ``--out DIR`` rank 0 writes each case's inputs and output shards to
``DIR/<case>.npz`` (keys ``<label>|<tensor>|<device>``), for a checker in
another process (the JAX package's tests) to hold against its own
simulator.  Rank 0 prints one line per case and one
``RUNTIME_SELFTEST_JSON {...}`` line: each case's ``ok``, its plan's step
kinds, and the traffic of its plans summed over the ranks (point-to-point
messages and bytes, collectives, bytes staged through host memory).  The
``async:*`` and ``search:*`` cases of the reference are not ported yet.
The sweep stops at the first case that fails on a rank; that rank prints
its report and exits non-zero.
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
            return {"plan_kind": plan.kind, "step_kinds": kinds}, stats
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


def api_cases(mesh, n: int, save) -> dict:
    """The ``api:*`` and switch cases over ``n`` devices."""
    api = _api()
    from repro_torch.api import testing

    def executors():
        return (("sim", api.SimulatorExecutor()),
                ("dist", api.DistExecutor(mesh)))

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
        # the last session is the DistExecutor's; its lowered graph is
        # cached under (plan, no fetch list, one microbatch)
        return {}, ex.lowered(sess.plan).comm_stats

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
        return {"runs": len(runs)}, None

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
        return {"loss": float(want_y.sum())}, None

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

    return {
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
        f"switch:dist/{n}": switch_case,
    }


def run_all(mesh, groups=("comm", "api"), out_dir=None) -> dict:
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
    ap.add_argument("--cases", default="comm,api",
                    help="comma-separated case groups: comm, api")
    ap.add_argument("--out", default=None,
                    help="directory for each case's shards (rank 0)")
    args = ap.parse_args(argv)
    groups = tuple(args.cases.split(","))
    if not set(groups) <= {"comm", "api"}:
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
    if not report["ok"]:
        # the other ranks may be inside the failed case's exchanges: exit
        # without a collective teardown (run_ranks kills them)
        return 1
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
