"""The port's scenario cost models against the JAX package's.

``repro_torch.scenarios`` (``hetero``, ``mixed_length``, ``search`` and
the ``elastic`` shim) and ``repro_torch.elastic.pricing`` are numpy
copies of ``repro.scenarios`` / ``repro.elastic.pricing`` that price
transitions through the port's own ``core.switching.plan_tensor_switch``.
Every priced output must equal the reference's; only host-clock
measurements (planning and specialization wall time) are left out.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import costmodel as jcm  # noqa: E402
from repro.elastic import pricing as jpricing  # noqa: E402
from repro.scenarios import elastic as jshim  # noqa: E402
from repro.scenarios import hetero as jhetero  # noqa: E402
from repro.scenarios import mixed_length as jmixed  # noqa: E402
from repro.scenarios import search as jss  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.elastic import pricing as tpricing  # noqa: E402
from repro_torch.scenarios import elastic as tshim  # noqa: E402
from repro_torch.scenarios import hetero as thetero  # noqa: E402
from repro_torch.scenarios import mixed_length as tmixed  # noqa: E402
from repro_torch.scenarios import search as tss  # noqa: E402

#: TransitionReport fields that are host-clock measurements
MEASURED = {"specialize_s", "switch_plan_s"}


def priced(reports):
    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k not in MEASURED} for r in reports]


def clusters(cm):
    return {"homog": (cm.ClusterSpec((cm.H20,) * 32), "TRACE_HOMOG"),
            "hetero": (cm.paper_cluster(16, 32), "TRACE_HETERO")}


@pytest.mark.parametrize("which", ["homog", "hetero"])
def test_run_trace_and_restart_baseline_equal_the_reference(which):
    jcluster, trace = clusters(jcm)[which]
    tcluster, _ = clusters(tcm)[which]
    jtrace, ttrace = getattr(jpricing, trace), getattr(tpricing, trace)
    assert ttrace == jtrace
    want = jpricing.run_trace(jtrace, jcluster)
    got = tpricing.run_trace(ttrace, tcluster)
    assert priced(got) == priced(want)
    assert any(r["messages"] for r in priced(got))   # transitions priced
    assert priced(tpricing.checkpoint_restart_baseline(ttrace, tcluster)) \
        == priced(jpricing.checkpoint_restart_baseline(jtrace, jcluster))
    for _, ranks in ttrace:
        assert repr(tpricing.two_pipeline_strategy(ranks, tcm.LLAMA_32B)) \
            == repr(jpricing.two_pipeline_strategy(ranks, jcm.LLAMA_32B))


def test_elastic_shim_reexports_the_pricing():
    for name in jshim.__all__:
        assert getattr(tshim, name) is getattr(tpricing, name)


@pytest.mark.parametrize("policy", ["baseline", "hotspa", "hetu_a",
                                    "hetu_b"])
def test_run_mixed_length_equals_the_reference(policy):
    want = jmixed.run_mixed_length(policy, n_steps=8, seed=3)
    got = tmixed.run_mixed_length(policy, n_steps=8, seed=3)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    if policy == "hetu_b":
        assert np.mean([r.seconds for r in got]) < np.mean(
            [r.seconds for r in tmixed.run_mixed_length("baseline",
                                                        n_steps=8, seed=3)])


@pytest.mark.parametrize("fast, slow", [(16, 16), (0, 16)])
def test_search_hetero_strategy_equals_the_reference(fast, slow):
    ranks = list(range(fast + slow))
    want = jss.search_hetero_strategy(jcm.paper_cluster(fast, slow),
                                      jcm.LLAMA_32B, ranks, 64, 4096)
    got = tss.search_hetero_strategy(tcm.paper_cluster(fast, slow),
                                     tcm.LLAMA_32B, ranks, 64, 4096)
    assert repr(got[0]) == repr(want[0])
    assert got[1] == want[1]


def test_schedule_report_equals_the_reference():
    def reports(cm, ss):
        strat = cm.uniform_strategy(list(range(16)), cm.LLAMA_32B, dp=2,
                                    tp=2, pp=4, global_batch=64)
        return [ss.schedule_report(strat),
                ss.schedule_report(strat, cm.paper_cluster(16, 16),
                                   cm.LLAMA_32B, seq_len=4096)]

    got = reports(tcm, tss)
    assert got == reports(jcm, jss)
    assert got[0] != got[1]      # priced ticks differ from uniform slots


@pytest.mark.parametrize("key", sorted(jhetero.HETU_STRATEGIES))
def test_hetu_strategies_and_annotations_equal_the_reference(key):
    model = {"llama-32b": "LLAMA_32B", "llama-70b": "LLAMA_70B"}[key[0]]
    jstrat = jhetero.HETU_STRATEGIES[key]()
    tstrat = thetero.HETU_STRATEGIES[key]()
    assert repr(tstrat) == repr(jstrat)
    jm, tm = getattr(jcm, model), getattr(tcm, model)
    for fn in ("strategy_annotations", "grad_sync_annotations"):
        want = getattr(jhetero, fn)(jstrat, jm)
        got = getattr(thetero, fn)(tstrat, tm)
        assert {k: repr(v) for k, v in got.items()} == \
            {k: repr(v) for k, v in want.items()}, fn
    assert thetero.layer_weight_shapes(tm) == jhetero.layer_weight_shapes(jm)
    cluster = (jcm.paper_cluster(key[1], key[2]),
               tcm.paper_cluster(key[1], key[2]))
    want = jhetero.priced_schedule_stats(cluster[0], jm, jstrat, 4096)
    got = thetero.priced_schedule_stats(cluster[1], tm, tstrat, 4096)
    assert [s.summary() for s in got] == [s.summary() for s in want]
    ja = jhetero.to_api_strategy("s", jstrat, jm)
    ta = thetero.to_api_strategy("s", tstrat, tm)
    assert {k: repr(v) for k, v in ta.annots.items()} == \
        {k: repr(v) for k, v in ja.annots.items()}
