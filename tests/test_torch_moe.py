"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's GSPMD dispatch (``repro/models/moe.py:_apply_moe_gspmd``, what
``apply_moe`` runs without a production mesh), on the CPU at reduced
widths: DeepSeek-V2's SwiGLU experts with a shared expert and Grok-1's
GELU experts without, under exact dispatch and at a capacity factor small
enough that assignments drop.  Weights are the JAX ``init_moe`` draws;
inputs come from a numpy seed.  y and the aux loss are held to atol 1e-5
(the same fp32 math, summed in other orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _configs(arch, **moe):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **moe)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                              **moe)))


def _run_both(jcfg, tcfg, seed, b=2, s=32):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(seed).standard_normal(
        (b, s, tcfg.d_model), dtype=np.float32)
    jy, jaux = jmoe._apply_moe_gspmd(jp, jnp.asarray(x), jcfg)
    tmoe.routing_log = []
    try:
        ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)
        (top_e, keep), = tmoe.routing_log
    finally:
        tmoe.routing_log = None
    return (np.asarray(jy), float(jaux)), (ty.numpy(), taux.item()), \
        (top_e, keep)


@pytest.mark.parametrize("shared", [1, 0], ids=["shared", "no-shared"])
@pytest.mark.parametrize("dispatch", [
    dict(exact=True), dict(exact=False, capacity_factor=0.5)],
    ids=["exact", "drops"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
def test_apply_moe_matches_jax_gspmd(arch, dispatch, shared):
    jcfg, tcfg = _configs(arch, n_shared=shared, **dispatch)
    (jy, jaux), (ty, taux), (top_e, keep) = _run_both(jcfg, tcfg, seed=1)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(taux, jaux, **TOL)
    assert taux > 0
    m = tcfg.moe
    tokens = 64
    assert top_e.shape == keep.shape == (tokens, m.top_k)
    # the published top-k order: each token's experts distinct
    assert (top_e[:, 0] != top_e[:, 1]).all()
    if dispatch["exact"]:
        assert keep.all()
    else:
        cap = tmoe.capacity(tokens, m)
        assert cap == int(tokens * m.top_k * 0.5 / m.n_experts) < tokens
        assert not keep.all()  # some assignments drop
        kept = torch.bincount(top_e[keep], minlength=m.n_experts)
        assert (kept <= cap).all()


def test_dropped_assignment_writes_nothing():
    """With capacity 1 each expert serves only its first token: the rest
    of the routed output is zero, only the shared expert remains."""
    jcfg, tcfg = _configs("grok-1-314b", exact=False, capacity_factor=0.01)
    (jy, _), (ty, _), (top_e, keep) = _run_both(jcfg, tcfg, seed=2)
    assert tmoe.capacity(64, tcfg.moe) == 1
    assert int(keep.sum()) == len(set(top_e[keep].tolist()))
    np.testing.assert_allclose(ty, jy, **TOL)
    served = keep.any(1).reshape(2, 32)
    assert np.abs(ty[~served.numpy()]).max() == 0.0


@pytest.mark.parametrize("tokens,top_k,factor,experts,exact", [
    (2048, 6, 1.25, 160, False),     # DeepSeek-V2 prefill at batch 4: 96
    (2048, 2, 1.25, 8, False),       # Grok-1 prefill at batch 4: 640
    (4, 6, 1.25, 160, False),        # a DeepSeek-V2 decode step: 1
    (4, 2, 1.25, 8, False),          # a Grok-1 decode step: 1
    (1000, 2, 1.0, 8, False),        # 250 -> 256, the 128 round-up
    (512, 2, 1.0, 8, False),         # 128 stays 128
    (520, 2, 1.0, 8, False),         # 130 -> 256
    (7, 2, 1.25, 4, True),           # exact: every token
])
def test_capacity_matches_jax(tokens, top_k, factor, experts, exact):
    _, tcfg = _configs("grok-1-314b")
    m = dataclasses.replace(tcfg.moe, top_k=top_k, capacity_factor=factor,
                            n_experts=experts, exact=exact)
    assert tmoe.capacity(tokens, m) == jmoe._capacity(tokens, m)


def test_init_moe_stacks_experts_as_the_reference():
    jcfg, tcfg = _configs("deepseek-v2-236b")
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg,
                       torch.float32, "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), tp) == shapes
    # experts are distinct draws
    up = tp["experts"]["up"]
    assert not torch.equal(up[0], up[1])
