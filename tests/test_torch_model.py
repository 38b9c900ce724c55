"""The port's model stack against the JAX package on the reduced qwen2-1.5b
(2 layers, d_model 256, 4 heads, 2 KV heads, head dim 64, vocab 512), with
the JAX ``init_params(PRNGKey(0))`` weights carried over by
``params_from_jax``.  Tolerances follow ``tests/test_archs.py``:
``atol=2e-3, rtol=1e-3`` for logits; the layers, which do the same fp32
math, are held to ``1e-5``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import policy as jax_policy  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.tree import paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

LOGITS_TOL = dict(atol=2e-3, rtol=1e-3)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config("qwen2-1.5b").reduced(), \
        get_config("qwen2-1.5b").reduced()


@pytest.fixture(scope="module")
def weights(cfgs):
    jcfg, tcfg = cfgs
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, convert.params_from_jax(tree, tcfg, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def test_config_copy_matches_reference(cfgs):
    jcfg, tcfg = cfgs
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
            tcfg.hd, tcfg.vocab) == (2, 256, 4, 2, 64, 512)
    full_j, full_t = jax_get_config("qwen2-1.5b"), get_config("qwen2-1.5b")
    assert repr(full_t) == repr(full_j)


def test_rms_norm_rope_mlp_match_jax(cfgs, weights):
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, tcfg.d_model), dtype=np.float32)
    w = rng.standard_normal((tcfg.d_model,), dtype=np.float32)
    np.testing.assert_allclose(
        tl.rms_norm({"w": torch.from_numpy(w)}, torch.from_numpy(x)).numpy(),
        np.asarray(jl.rms_norm({"w": jnp.asarray(w)}, jnp.asarray(x))),
        **LAYER_TOL)
    bias = rng.standard_normal((tcfg.d_model,), dtype=np.float32)
    np.testing.assert_allclose(
        tl.layer_norm({"w": torch.from_numpy(w), "b": torch.from_numpy(bias)},
                      torch.from_numpy(x)).numpy(),
        np.asarray(jl.layer_norm({"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                                 jnp.asarray(x))), **LAYER_TOL)

    h = rng.standard_normal((2, 16, 4, 64), dtype=np.float32)
    pos = np.broadcast_to(np.arange(100, 116)[None], (2, 16)).copy()
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                      tcfg.rope_theta).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(h), jnp.asarray(pos),
                                 jcfg.rope_theta)), **LAYER_TOL)

    jmlp = jax.tree.map(lambda a: a[0], jparams["groups"]["g0_dense"]["mlp"])
    tmlp = {k: v[0] for k, v in tparams["groups"]["g0_dense"]["mlp"].items()}
    np.testing.assert_allclose(
        tl.apply_mlp(tmlp, torch.from_numpy(x), tcfg.mlp).numpy(),
        np.asarray(jl.apply_mlp(jmlp, jnp.asarray(x), jcfg.mlp)),
        **LAYER_TOL)


@pytest.mark.parametrize("jax_policy_name", ["ref", "pallas"])
def test_forward_last_only_matches_jax(cfgs, weights, jax_policy_name):
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    toks = _tokens(2, 2, 128, tcfg.vocab)
    jax_policy.set_policy(jax_policy_name)
    try:
        jlog, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                             last_only=True)
    finally:
        jax_policy.set_policy("auto")
    tlog, aux = tm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                           tcfg, last_only=True)
    assert tlog.shape == (2, 1, tcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS_TOL)


def test_decode_steps_match_jax_and_forward(cfgs, weights):
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    B, S = 2, 12
    toks = _tokens(3, B, S, tcfg.vocab)
    jstate = jm.init_decode_state(jcfg, B, max_len=S)
    tstate = tm.init_decode_state(tcfg, B, max_len=S, device="cpu")
    jstep = jax.jit(lambda p, s, b: jm.decode_step(p, s, b, jcfg))
    touts = []
    for t in range(S):
        jlog, jstate = jstep(jparams, jstate, {"tokens": toks[:, t:t + 1]})
        tlog, tstate = tm.decode_step(
            tparams, tstate, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGITS_TOL)
        touts.append(tlog[:, 0])
    assert tstate["pos"] == S
    full, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(torch.stack(touts, 1).numpy(), full.numpy(),
                               **LOGITS_TOL)


def test_serving_pair_matches_jax(cfgs, weights):
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    B, P = 2, 128
    toks = _tokens(4, B, P + 1, tcfg.vocab)
    jpre = jsteps.build_prefill_step(jcfg)(jparams,
                                           {"tokens": jnp.asarray(toks[:, :P])})
    tpre = tsteps.build_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(toks[:, :P])})
    assert tpre.shape == (B, tcfg.vocab)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **LOGITS_TOL)

    jstate = jm.init_decode_state(jcfg, B, max_len=4)
    tstate = tm.init_decode_state(tcfg, B, max_len=4, device="cpu")
    jstep = jax.jit(jsteps.build_decode_step(jcfg))
    tstep = tsteps.build_decode_step(tcfg)
    for t in range(3):
        jlog, jstate = jstep(jparams, jstate, {"tokens": toks[:, t:t + 1]})
        tlog, tstate = tstep(tparams, tstate,
                             {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        assert tlog.shape == (B, tcfg.vocab)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGITS_TOL)
    assert fa.launches == 0  # CPU tensors never reach the kernel


def test_params_from_jax_uses_every_leaf_once(cfgs):
    _, tcfg = cfgs
    shapes = convert.param_shapes(tcfg)
    # distinct values per leaf: leaf i holds i + 0.5 everywhere
    tree: dict = {}
    for i, (path, shape) in enumerate(shapes.items()):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.full(shape, i + 0.5, np.float32)
    params = convert.params_from_jax(tree, tcfg, device="cpu")
    leaves = list(paths(params))
    assert len(leaves) == len(shapes)
    seen = sorted(float(t.flatten()[0]) for _, t in leaves)
    assert seen == [i + 0.5 for i in range(len(shapes))]
    src = dict(paths(tree))
    for path, t in leaves:
        np.testing.assert_array_equal(t.numpy(), src[path])

    extra = dict(tree, stray={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unused JAX parameters: stray/w"):
        convert.params_from_jax(extra, tcfg, device="cpu")
    missing = dict(tree)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="lack final_norm/w"):
        convert.params_from_jax(missing, tcfg, device="cpu")


def test_jax_init_tree_converts_one_to_one(cfgs, weights):
    _, tcfg = cfgs
    jparams, tparams = weights
    jleaves = dict(paths(jax.tree.map(np.asarray, jparams)))
    tleaves = dict(paths(tparams))
    assert jleaves.keys() == tleaves.keys()
    for path, t in tleaves.items():
        np.testing.assert_array_equal(t.numpy(), jleaves[path])
    # the port's own init builds the same tree
    own = tm.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert {p: tuple(t.shape) for p, t in paths(own)} \
        == convert.param_shapes(tcfg)


def test_sdpa_query_chunked_path_matches_one_block():
    """Long sequences take the query-chunked plain path (Sq*Sk above 8M)."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 2048, 2, 8), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 4096, 1, 8), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 4096, 1, 8), np.float32))
    chunked = tl.sdpa(q, k, v, causal=True)
    whole = tl._sdpa_block(q, k, v, causal=True, window=None, q_offset=0,
                           length_mask=None)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b",
                                  "qwen2-vl-72b", "whisper-large-v3"])
def test_new_families_convert_one_to_one(arch):
    """The MoE, MLA, embedding-input and encoder-decoder trees carry over
    leaf for leaf: each JAX leaf used once, at its path and shape, and
    back again."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jtree = jax.tree.map(np.asarray,
                         jm.init_params(jax.random.PRNGKey(1), jcfg))
    params = convert.params_from_jax(jtree, tcfg, device="cpu")
    src = dict(paths(jtree))
    got = dict(paths(params))
    assert got.keys() == src.keys() == convert.param_shapes(tcfg).keys()
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), src[path])
    back = dict(paths(convert.params_to_jax(params, tcfg)))
    assert back.keys() == src.keys()
    for path, a in back.items():
        np.testing.assert_array_equal(a, src[path])


def test_entry_points_default_to_cuda_and_raise_without_it(cfgs, monkeypatch):
    _, tcfg = cfgs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(tcfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_decode_state(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax({}, tcfg)
