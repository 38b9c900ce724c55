"""The port's expert-parallel MoE (``repro_torch/models/moe.py``:
``apply_moe_ep`` and the gate in ``apply_moe``).

* On a 1 x 1 mesh, against the JAX package's ``apply_moe_ep_shmap`` on a
  1 x 1 mesh of the one CPU device, exact and at a capacity that drops,
  atol 1e-5 (``tests/test_moe.py``'s tolerance); JAX's weights.
* At 2 and 4 gloo ranks on the CPU (``launch/moe_ep.py``: (data, model)
  = (1, 2) and (2, 2), 4096 tokens, reduced DeepSeek-V2 in exact mode),
  against the port's single-process capacity dispatch: routing bitwise, y
  normwise 1e-5, aux 1e-6 relative.
* The gate's four conditions, and the single-process carrier on a (2, 2)
  logical mesh.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import LogicalMesh, make_smoke_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.runtime.harness import run_ranks  # noqa: E402
from repro_torch.sharding import hints  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _configs(arch, **kw):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **kw)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                              **kw)))


@pytest.mark.parametrize("dispatch", [
    dict(exact=True), dict(exact=False, capacity_factor=0.5)],
    ids=["exact", "capacity"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
def test_ep_one_by_one_matches_jax_shard_map(arch, dispatch):
    jcfg, tcfg = _configs(arch, **dispatch)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(3).standard_normal((2, 32, tcfg.d_model),
                                                 dtype=np.float32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with mesh:
        jy, jaux = jmoe.apply_moe_ep_shmap(jp, jnp.asarray(x), jcfg, mesh)
    with hints.use_mesh(make_smoke_mesh()):
        ty, taux = tmoe.apply_moe_ep(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("ranks,mesh", [(2, (1, 2)), (4, (2, 2))])
def test_ep_on_gloo_ranks_matches_capacity_dispatch(ranks, mesh):
    outs = run_ranks("repro_torch.launch.moe_ep", ranks, backend="gloo",
                     device="cpu", timeout=240,
                     extra_args=["--reduced", "--exact", "--tokens", "4096",
                                 "--data", str(mesh[0]),
                                 "--model", str(mesh[1])])
    line, = [ln for ln in outs[0].stdout.splitlines()
             if ln.startswith("MOE_EP_JSON ")]
    r = json.loads(line.split(" ", 1)[1])
    assert r["routing_bitwise"]
    assert r["y_normwise"] <= 1e-5, r
    assert r["aux_rel"] <= 1e-6, r
    # one all-reduce of the partial output and the aux, fp32
    t_loc = 4096 // mesh[0]
    assert r["staged_bytes"] == (t_loc * 256 + 1) * 4


def test_gate_conditions():
    cfg = get_config("deepseek-v2-236b")        # 160 experts
    m16 = LogicalMesh(("data", "model"), (16, 16))
    assert tmoe.ep_gate(m16, cfg, 4096)
    assert not tmoe.ep_gate(None, cfg, 4096)                   # no mesh
    assert not tmoe.ep_gate(LogicalMesh(("data",), (16,)), cfg, 4096)
    assert not tmoe.ep_gate(LogicalMesh(("data", "model"), (16, 7)),
                            cfg, 4096)                        # E % tp
    assert not tmoe.ep_gate(m16, cfg, 4095)                    # tokens
    assert not tmoe.ep_gate(LogicalMesh(("data", "model"), (3, 16)),
                            cfg, 4096)                        # % data
    assert tmoe.ep_gate(LogicalMesh(("pod", "data", "model"), (2, 2, 16)),
                        cfg, 4096)


def test_apply_moe_takes_ep_under_the_gate_only():
    """Under the smoke mesh at >= 4096 tokens apply_moe is apply_moe_ep;
    below it, the capacity dispatch; at 1 x 1 the two agree bitwise."""
    _, cfg = _configs("deepseek-v2-236b")
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(g, cfg, torch.float32, "cpu")
    x = torch.randn((1, 4096, cfg.d_model), generator=g)
    with hints.use_mesh(make_smoke_mesh()):
        y_ep, aux_ep = tmoe.apply_moe(p, x, cfg)
        y_small, _ = tmoe.apply_moe(p, x[:, :64], cfg)
    y_cap, aux_cap = tmoe._apply_moe_gspmd(p, x, cfg)
    assert torch.equal(y_ep, y_cap) and torch.equal(aux_ep, aux_cap)
    torch.testing.assert_close(y_small, tmoe._apply_moe_gspmd(
        p, x[:, :64], cfg)[0], rtol=0, atol=0)


def test_single_process_carrier_two_by_two():
    """apply_moe_ep on a (2, 2) logical mesh in one process (every batch
    shard x model shard in turn) against the capacity dispatch per batch
    shard, exact mode."""
    _, cfg = _configs("grok-1-314b", exact=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           n_experts=4))
    g = torch.Generator().manual_seed(1)
    p = tmoe.init_moe(g, cfg, torch.float32, "cpu")
    x = torch.randn((2, 32, cfg.d_model), generator=g)
    with hints.use_mesh(LogicalMesh(("data", "model"), (2, 2))):
        y, aux = tmoe.apply_moe_ep(p, x, cfg)
    for i in range(2):
        yi, _ = tmoe._apply_moe_gspmd(p, x[i:i + 1], cfg)
        torch.testing.assert_close(y[i:i + 1], yi, **{"atol": 1e-5,
                                                      "rtol": 1e-5})


@pytest.mark.parametrize("seq,want", [(2048, True), (512, False)])
def test_trainer_takes_ep_where_the_reference_does(monkeypatch, seq, want):
    """launch.train steps under the smoke mesh, as the reference's trainer
    does: a microbatch of 2 x 2048 tokens takes apply_moe_ep, 2 x 512
    the capacity dispatch."""
    from repro_torch.launch import train
    calls = []
    real = tmoe.apply_moe_ep

    def spy(*a, **kw):
        calls.append(hints.active_mesh())
        return real(*a, **kw)
    monkeypatch.setattr(tmoe, "apply_moe_ep", spy)
    out = train.main(["--device", "cpu", "--reduced", "--arch",
                      "deepseek-v2-236b", "--steps", "1", "--batch", "2",
                      "--seq", str(seq), "--microbatches", "1",
                      "--no-strategy-report"])
    assert np.isfinite(out["losses"][0])
    assert bool(calls) == want
    assert all(m.shape == {"data": 1, "model": 1} for m in calls)
    assert hints.active_mesh() is None


@pytest.mark.parametrize("n", [1, 5, 160])
def test_positions_rank_each_id_in_token_order(n):
    """``positions`` (the dispatch's within-expert slots, shared by the
    capacity dispatch, ``ep_local`` and the rank check) against a plain
    count over the ids in order."""
    flat = torch.from_numpy(
        np.random.default_rng(n).integers(0, n, 997)).long()
    seen, want = {}, []
    for e in flat.tolist():
        want.append(seen.get(e, 0))
        seen[e] = want[-1] + 1
    assert tmoe.positions(flat, n).tolist() == want


@pytest.mark.parametrize("arch,shape,want", [
    ("deepseek-v2-236b", "train_4k", "ep"),
    ("deepseek-v2-236b", "prefill_32k", "ep"),
    ("deepseek-v2-236b", "decode_32k", "ep-standin"),
    ("grok-1-314b", "train_4k", "width-standin"),
    ("grok-1-314b", "decode_32k", "width-standin"),
])
def test_dryrun_names_the_moe_formulation(arch, shape, want):
    """On 16 x 16 the dry run reports which MoE layers run the reference's
    expert-parallel formulation and which a stand-in for its capacity
    dispatch: below 4096 tokens a microbatch, or an expert count (Grok-1's
    8) that ``model`` does not divide."""
    from repro_torch.launch.dryrun import N_MICRO, moe_formulation
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import INPUT_SHAPES
    s = INPUT_SHAPES[shape]
    got = moe_formulation(get_config(arch), make_production_mesh(), s,
                          N_MICRO if s.kind == "train" else 1)
    assert got["formulation"] == want
    assert got["what"] == tmoe.DTENSOR_FORMULATIONS[want]
    assert moe_formulation(get_config("qwen2-1.5b"), make_production_mesh(),
                           s) is None
