"""The port's RG-LRU scan, windowed attention and RecurrentGemma (Griffin)
stack against the JAX package, and flash attention at head dim 256.

Inputs are made with numpy from a seed and handed to both frameworks.  On
the CPU the port's wrappers and dispatch take the plain versions; the JAX
side runs its Pallas kernels in interpret mode and its own oracles.

Tolerances: the plain scan against the JAX kernel and oracle in fp32 at
``atol=rtol=1e-4`` (a doubling scan against an associative scan and a
sequential one: the same products, other association); in bf16 at the
JAX kernel test's own ``atol=1e-1, rtol=3e-2`` (``tests/test_kernels.py``).
Blocks at ``1e-5``; logits at ``tests/test_archs.py``'s
``atol=2e-3, rtol=1e-3``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import policy as jax_policy  # noqa: E402
from repro.kernels.ref import rglru_ref as jax_rglru_ref  # noqa: E402
from repro.kernels.rglru_scan import rglru_pallas  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, policy  # noqa: E402
from repro_torch.kernels import rglru_scan as rk  # noqa: E402
from repro_torch.kernels.ref import rglru_ref  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCH = "recurrentgemma-9b"
SCAN_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
            "bfloat16": dict(atol=1e-1, rtol=3e-2)}
LOGITS_TOL = dict(atol=2e-3, rtol=1e-3)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _auto_policy():
    policy.set_policy("auto")
    rk.launches = fa.launches = 0
    yield
    policy.set_policy("auto")


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def weights(cfgs):
    jcfg, tcfg = cfgs
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, convert.params_from_jax(tree, tcfg, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _scan_inputs(seed, b, s, w, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, w)) * 0.5).astype(np.float32)
    r = 1 / (1 + np.exp(-rng.standard_normal((b, s, w))))
    i = 1 / (1 + np.exp(-rng.standard_normal((b, s, w))))
    lam = (rng.standard_normal(w) * 0.5).astype(np.float32)
    arrs = [x, r.astype(np.float32), i.astype(np.float32)]
    t = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    return t + [torch.from_numpy(lam)], j + [jnp.asarray(lam)]


# the sweep shapes of tests/test_kernels.py, fp32; s = 384 crosses three
# 128-step chunks of the JAX kernel; one bf16 case
@pytest.mark.parametrize("dtype,b,s,w,chunk", [
    ("float32", 1, 128, 128, 64),
    ("float32", 2, 256, 256, 128),
    ("float32", 1, 384, 128, 128),
    ("bfloat16", 2, 256, 256, 128),
])
def test_rglru_ref_matches_jax(dtype, b, s, w, chunk):
    (tx, tr, ti, tlam), (jx, jr, ji, jlam) = _scan_inputs(5, b, s, w, dtype)
    y = rglru_ref(tx, tr, ti, tlam)
    assert y.shape == (b, s, w) and y.dtype == TORCH_DT[dtype]
    for want in (rglru_pallas(jx, jr, ji, jlam, chunk=chunk, interpret=True),
                 jax_rglru_ref(jx, jr, ji, jlam)):
        np.testing.assert_allclose(_np(y), _np(want), **SCAN_TOL[dtype])
    for got in (rk.rglru_scan(tx, tr, ti, tlam), ops.rglru(tx, tr, ti, tlam)):
        np.testing.assert_array_equal(_np(got), _np(y))
    assert rk.launches == 0


def test_rglru_ref_matches_stepwise_decode_at_ragged_sizes():
    """Any s and w (here 200 and 96): the doubling scan equals the one-step
    recurrence that decode runs, and the JAX oracle."""
    (tx, tr, ti, tlam), (jx, jr, ji, jlam) = _scan_inputs(6, 2, 200, 96,
                                                          "float32")
    y = rglru_ref(tx, tr, ti, tlam)
    h = torch.zeros((2, 96))
    steps = []
    for t in range(200):
        yt, h = trg.rglru_decode_step(tx[:, t:t + 1], tr[:, t:t + 1],
                                      ti[:, t:t + 1], tlam, h)
        steps.append(yt)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), y.numpy(),
                               **SCAN_TOL["float32"])
    np.testing.assert_allclose(y.numpy(), _np(jax_rglru_ref(jx, jr, ji, jlam)),
                               **SCAN_TOL["float32"])


def _sub(params, j):
    """Sub-block j of the first Griffin superblock, for both frameworks."""
    jparams, tparams = params
    jp = jax.tree.map(lambda a: a[0],
                      jparams["groups"]["g0_griffin"]["subs"][j])
    tp = tm._layer(tparams["groups"]["g0_griffin"]["subs"][j], 0)
    return jp, tp


def test_apply_recurrent_block_prefill_and_decode_match_jax(cfgs, weights):
    jcfg, tcfg = cfgs
    jp, tp = _sub(weights, 0)
    rng = np.random.default_rng(7)
    # 128 tokens and width 256 pass the JAX gate: the JAX side runs its
    # kernel in interpret mode under policy "pallas"
    x = rng.standard_normal((2, 128, tcfg.d_model)).astype(np.float32)
    y, nc = trg.apply_recurrent_block(tp["mixer"], torch.from_numpy(x), tcfg)
    assert nc is None
    for pol in ("ref", "pallas"):
        jax_policy.set_policy(pol)
        try:
            jy, _ = jrg.apply_recurrent_block(jp["mixer"], jnp.asarray(x),
                                              jcfg)
        finally:
            jax_policy.set_policy("auto")
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)

    w = tcfg.hybrid.lru_width
    cache = {"conv": rng.standard_normal(
        (2, tcfg.hybrid.conv_width - 1, w)).astype(np.float32),
        "h": rng.standard_normal((2, w)).astype(np.float32)}
    y1, tc = trg.apply_recurrent_block(
        tp["mixer"], torch.from_numpy(x[:, :1]), tcfg,
        {k: torch.from_numpy(v) for k, v in cache.items()})
    jy1, jc = jrg.apply_recurrent_block(
        jp["mixer"], jnp.asarray(x[:, :1]), jcfg,
        {k: jnp.asarray(v) for k, v in cache.items()})
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), **LAYER_TOL)
    assert tc["h"].dtype == torch.float32
    for key in ("conv", "h"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **LAYER_TOL)


@pytest.mark.parametrize("cache_len", [64, 88])
def test_windowed_attention_decode_branches_match_jax(cfgs, weights,
                                                      cache_len):
    """Window 64.  A cache of 64 slots is a ring buffer (slot idx % 64); a
    cache of 88 is written at idx and masked by the window with the query
    at offset idx.  Both against JAX's apply_attention, at a step that
    wrapped the ring / passed the window."""
    jcfg, tcfg = cfgs
    jp, tp = _sub(weights, 2)
    K, hd = tcfg.n_kv_heads, tcfg.hd
    rng = np.random.default_rng(8)
    k = rng.standard_normal((2, cache_len, K, hd)).astype(np.float32)
    v = rng.standard_normal((2, cache_len, K, hd)).astype(np.float32)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    idx = 77 if cache_len == 88 else 70
    pos = np.full((2, 1), idx)
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(
        v.copy()), "idx": idx}
    y, tc = tl.apply_attention(tp["mixer"], torch.from_numpy(x), tcfg,
                               positions=torch.from_numpy(pos),
                               window=tcfg.hybrid.window, cache=tcache)
    jy, jc = jl.apply_attention(jp["mixer"], jnp.asarray(x), jcfg,
                                positions=jnp.asarray(pos),
                                window=jcfg.hybrid.window,
                                cache={"k": jnp.asarray(k),
                                       "v": jnp.asarray(v),
                                       "idx": jnp.int32(idx)})
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               **LAYER_TOL)
    assert tc["idx"] == idx + 1 and tc["k"] is tcache["k"]  # in place
    slot = idx % cache_len if cache_len <= tcfg.hybrid.window else idx
    assert not np.array_equal(tc["k"][:, slot].numpy(), k[:, slot])


@pytest.mark.parametrize("jax_policy_name", ["ref", "pallas"])
def test_hybrid_forward_last_only_matches_jax(cfgs, weights,
                                              jax_policy_name):
    """Under JAX policy "pallas" the JAX side runs its RG-LRU and flash
    kernels in interpret mode (128 tokens, width 256 pass both gates)."""
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    toks = np.random.default_rng(9).integers(0, tcfg.vocab, (2, 128))
    jax_policy.set_policy(jax_policy_name)
    try:
        jlog, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                             last_only=True)
    finally:
        jax_policy.set_policy("auto")
    tlog, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                         last_only=True)
    assert tlog.shape == (2, 1, tcfg.vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS_TOL)


@pytest.mark.parametrize("max_len", [88, 64])
def test_hybrid_decode_88_tokens_matches_jax_and_forward(cfgs, weights,
                                                         max_len):
    """88 tokens through the reduced hybrid (window 64).  The attention
    cache holds min(window, max_len) = 64 slots either way, a ring buffer
    that wraps after 64 steps; held against JAX's decode and the port's
    own full forward (the window masks it the same way)."""
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    B, S = 2, 88
    toks = np.random.default_rng(10).integers(0, tcfg.vocab, (B, S))
    jstate = jm.init_decode_state(jcfg, B, max_len=max_len)
    tstate = tm.init_decode_state(tcfg, B, max_len=max_len, device="cpu")
    rec, _, attn = tstate["caches"]["g0_griffin"]
    assert attn["k"].shape == (1, B, 64, tcfg.n_kv_heads, tcfg.hd)
    assert rec["h"].dtype == torch.float32 and attn["idx"] == 0
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
    assert tstate["caches"]["g0_griffin"][2]["idx"] == S
    full, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(torch.stack(touts, 1).numpy(), full.numpy(),
                               **LOGITS_TOL)
    assert rk.launches == fa.launches == 0


def test_hybrid_serving_pair_matches_jax(cfgs, weights):
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    B, P = 2, 128
    toks = np.random.default_rng(11).integers(0, tcfg.vocab, (B, P))
    jpre = jsteps.build_prefill_step(jcfg)(jparams,
                                           {"tokens": jnp.asarray(toks)})
    tpre = tsteps.build_prefill_step(tcfg)(tparams,
                                           {"tokens": torch.from_numpy(toks)})
    assert tpre.shape == (B, tcfg.vocab)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **LOGITS_TOL)
    jstate = jm.init_decode_state(jcfg, B, max_len=8)
    tstate = tm.init_decode_state(tcfg, B, max_len=8, device="cpu")
    jstep = jax.jit(jsteps.build_decode_step(jcfg))
    tstep = tsteps.build_decode_step(tcfg)
    for t in range(3):
        jlog, jstate = jstep(jparams, jstate, {"tokens": toks[:, t:t + 1]})
        tlog, tstate = tstep(tparams, tstate,
                             {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGITS_TOL)


def test_hybrid_params_convert_one_to_one_with_list_paths(cfgs, weights):
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    shapes = convert.param_shapes(tcfg)
    assert ("groups", "g0_griffin", "subs", 0, "mixer", "in_x") in shapes
    assert convert.path_str(next(p for p in shapes if "lam" in p)) \
        == "groups/g0_griffin/subs/0/mixer/lam"
    jleaves = dict(convert._flatten(jax.tree.map(np.asarray, jparams)))
    tleaves = dict(convert._flatten(tparams))
    assert jleaves.keys() == tleaves.keys() == shapes.keys()
    for path, t in tleaves.items():
        np.testing.assert_array_equal(t.numpy(), jleaves[path])
    assert isinstance(tparams["groups"]["g0_griffin"]["subs"], list)
    own = tm.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert {p: tuple(t.shape) for p, t in convert._flatten(own)} == shapes
    half = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                   device="cpu", dtype=torch.bfloat16)
    assert half["groups"]["g0_griffin"]["subs"][0]["mixer"]["lam"].dtype \
        == torch.float32


def test_hybrid_converter_uses_every_leaf_once(cfgs):
    """Distinct values per leaf go where their list path says; a stray or
    a missing leaf raises with its path."""
    _, tcfg = cfgs
    shapes = convert.param_shapes(tcfg)
    tree: dict = {}
    for i, (path, shape) in enumerate(shapes.items()):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.full(shape, i + 0.5, np.float32)

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if all(isinstance(k, int) for k in node):
            return [node[i] for i in range(len(node))]
        return node
    tree = lists(tree)
    params = convert.params_from_jax(tree, tcfg, device="cpu")
    leaves = list(convert._flatten(params))
    assert sorted(float(t.flatten()[0]) for _, t in leaves) \
        == [i + 0.5 for i in range(len(shapes))]
    tree["groups"]["g0_griffin"]["subs"][1]["stray"] = np.zeros(3)
    with pytest.raises(ValueError, match="unused JAX parameters: "
                       "groups/g0_griffin/subs/1/stray"):
        convert.params_from_jax(tree, tcfg, device="cpu")
    del tree["groups"]["g0_griffin"]["subs"][1]["stray"]
    del tree["groups"]["g0_griffin"]["subs"][2]["mixer"]["wq"]
    with pytest.raises(ValueError, match="lack groups/g0_griffin/subs/2/"
                       "mixer/wq"):
        convert.params_from_jax(tree, tcfg, device="cpu")


def test_full_width_init_shapes_and_layer_groups():
    """RecurrentGemma-9B: 12 (rec, rec, attn) superblocks and a (rec, rec)
    tail.  The config does not tie the embeddings, so the shapes the port
    allocates hold 10.44 B parameters: 9.40 B and a 1.05 B LM head."""
    cfg = get_config(ARCH)
    assert tm.layer_groups(cfg) == [("griffin", 12), ("griffin_tail", 1)]
    assert tm.griffin_pattern(cfg, "griffin_tail") == ("rec", "rec")
    shapes = convert.param_shapes(cfg)
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert shapes[("lm_head",)] == (4096, 256000)
    assert 10.44e9 < n < 10.45e9


def test_flash_attention_takes_head_dim_256(monkeypatch):
    """RecurrentGemma-9B's local attention (head dim 256) resolves to the
    kernel on a device the policy sends to the kernels; a shape the kernel
    cannot take raises there instead of taking the plain version."""
    monkeypatch.setattr(policy, "use_kernels", lambda device: True)
    assert policy.select_attention_impl((4, 16, 512, 256), (4, 1, 512, 256),
                                        "cuda") == "cuda"
    with pytest.raises(ValueError, match="does not take"):
        policy.select_attention_impl((4, 16, 512, 96), (4, 1, 512, 96),
                                     "cuda")
    with pytest.raises(ValueError, match="does not take"):
        policy.select_attention_impl((4, 16, 512, 512), (4, 1, 512, 512),
                                     "cuda")


def test_cuda_attention_outside_the_kernel_raises_under_auto():
    """Without the monkeypatch: a CUDA device under "auto" and a head dim
    the kernel lacks raises; under "ref" it takes the plain version."""
    with pytest.raises(ValueError, match="does not take"):
        policy.select_attention_impl((1, 4, 128, 96), (1, 2, 128, 96),
                                     "cuda")
    policy.set_policy("ref")
    assert policy.select_attention_impl((1, 4, 128, 96), (1, 2, 128, 96),
                                        "cuda") == "ref"


def test_rglru_dispatch_and_wrapper_raise_off_the_kernel():
    assert policy.select_rglru_impl((4, 512, 4096), "cuda") == "cuda"
    assert policy.select_rglru_impl((4, 512, 4096), "cpu") == "ref"
    with pytest.raises(ValueError, match="does not take"):
        policy.select_rglru_impl((70000, 128, 128), "cuda")
    meta = dict(device="meta")
    x = torch.empty((1, 128, 128), dtype=torch.float16, **meta)
    with pytest.raises(TypeError):
        rk.rglru_scan(x, x, x, torch.empty((128,), **meta))
    x = torch.empty((1, 128, 128), **meta)
    with pytest.raises(ValueError, match="shape mismatch"):
        rk.rglru_scan(x, x, x, torch.empty((64,), **meta))
    assert rk.launches == 0
