"""The port's SSD scan and Mamba2 stack against the JAX package.

Inputs are made with numpy from a seed and handed to both frameworks.  On
the CPU the port's wrappers and dispatch take the plain versions; the JAX
side runs its Pallas kernel in interpret mode and its own oracle.

Tolerances: the plain scan against the JAX kernel and oracle in fp32 at
``atol=rtol=1e-4`` (the same math summed in another order: einsum
contraction order and the inter-chunk loop); in bf16 at the JAX kernel
test's own ``atol=2e-1, rtol=5e-2`` (``tests/test_kernels.py``: bf16
scores and x * dt round at other points).  Blocks at ``1e-5``; logits at
``tests/test_archs.py``'s ``atol=2e-3, rtol=1e-3``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import policy as jax_policy  # noqa: E402
from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_pallas  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.tree import paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, policy  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ARCH = "mamba2-370m"
SCAN_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
            "bfloat16": dict(atol=2e-1, rtol=5e-2)}
LOGITS_TOL = dict(atol=2e-3, rtol=1e-3)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _auto_policy():
    policy.set_policy("auto")
    sk.launches = 0
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


def _scan_inputs(seed, b, s, h, p, n):
    """x, dt (softplus-ed), A (< 0), B, C as in tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _both(x, dt, A, B, C, dtype):
    """torch and jax copies; x, B, C in ``dtype``, dt and A in fp32."""
    t = (torch.from_numpy(x).to(TORCH_DT[dtype]), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(B).to(TORCH_DT[dtype]),
         torch.from_numpy(C).to(TORCH_DT[dtype]))
    jd = getattr(jnp, dtype)
    j = (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B, jd), jnp.asarray(C, jd))
    return t, j


# the sweep shapes of tests/test_kernels.py:80-84, fp32, and one bf16 case
@pytest.mark.parametrize("dtype,b,s,h,p,n,chunk", [
    ("float32", 1, 128, 2, 64, 128, 64),
    ("float32", 2, 256, 4, 64, 128, 128),
    ("float32", 1, 192, 2, 32, 64, 64),       # 3 chunks, small head/state
    ("bfloat16", 2, 256, 4, 64, 128, 128),
])
def test_ssd_scan_ref_matches_jax(dtype, b, s, h, p, n, chunk):
    (tx, tdt, tA, tB, tC), (jx, jdt, jA, jB, jC) = _both(
        *_scan_inputs(3, b, s, h, p, n), dtype)
    y, st = ssd_scan_ref(tx, tdt, tA, tB, tC, chunk)
    assert y.shape == (b, s, h, p) and y.dtype == TORCH_DT[dtype]
    assert st.shape == (b, h, p, n) and st.dtype == torch.float32
    for jy, jst in (jax_ssd_pallas(jx, jdt, jA, jB, jC, chunk=chunk,
                                   interpret=True),
                    jax_ssd_ref(jx, jdt, jA, jB, jC, chunk)):
        np.testing.assert_allclose(_np(y), _np(jy), **SCAN_TOL[dtype])
        np.testing.assert_allclose(_np(st), _np(jst), **SCAN_TOL[dtype])
    # on CPU tensors the wrapper and the dispatch are the plain version
    for yy, ss in (sk.ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk),
                   ops.ssd(tx, tdt, tA, tB, tC, chunk=chunk)):
        np.testing.assert_array_equal(_np(yy), _np(y))
        np.testing.assert_array_equal(_np(ss), _np(st))
    assert sk.launches == 0


def test_ssd_scan_ref_pads_a_ragged_sequence_like_jax():
    """s not a multiple of the chunk: dt = 0 padding leaves the state
    alone (the branch at repro/models/ssm.py:34-43)."""
    (tx, tdt, tA, tB, tC), (jx, jdt, jA, jB, jC) = _both(
        *_scan_inputs(4, 2, 100, 3, 32, 16), "float32")
    y, st = ssd_scan_ref(tx, tdt, tA, tB, tC, 32)
    jy, jst = jssm.ssd_chunked(jx, jdt, jA, jB, jC, 32)
    assert y.shape == (2, 100, 3, 32)
    np.testing.assert_allclose(y.numpy(), _np(jy), **SCAN_TOL["float32"])
    np.testing.assert_allclose(st.numpy(), _np(jst), **SCAN_TOL["float32"])


def test_ssd_decode_steps_match_the_scan():
    """The port's one-token update, stepped over a sequence, reaches the
    chunked scan's outputs and final state."""
    tx, tdt, tA, tB, tC = map(torch.from_numpy,
                              _scan_inputs(5, 1, 64, 2, 32, 16))
    y, st = ssd_scan_ref(tx, tdt, tA, tB, tC, 16)
    state = torch.zeros((1, 2, 32, 16))
    ys = []
    for t in range(64):
        yt, state = tssm.ssd_decode_step(
            tx[:, t:t + 1], tdt[:, t:t + 1], tA, tB[:, t:t + 1],
            tC[:, t:t + 1], state)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), st.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_apply_mamba2_prefill_and_decode_match_jax(cfgs, weights):
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["g0_mamba"]["mixer"])
    tp = tm._layer(tparams["groups"]["g0_mamba"]["mixer"], 0)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    y, nc = tssm.apply_mamba2(tp, torch.from_numpy(x), tcfg)
    jy, _ = jssm.apply_mamba2(jp, jnp.asarray(x), jcfg)
    assert nc is None
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)

    s = tcfg.ssm
    din, nh = s.d_inner(tcfg.d_model), s.n_heads(tcfg.d_model)
    conv = rng.standard_normal((2, s.d_conv - 1, din + 2 * s.d_state))
    state = rng.standard_normal((2, nh, s.head_dim, s.d_state))
    x1 = x[:, :1]
    cache = {"conv": conv.astype(np.float32), "state": state.astype(
        np.float32)}
    y1, tc = tssm.apply_mamba2(
        tp, torch.from_numpy(x1),
        tcfg, {k: torch.from_numpy(v) for k, v in cache.items()})
    jy1, jc = jssm.apply_mamba2(
        jp, jnp.asarray(x1), jcfg, {k: jnp.asarray(v)
                                    for k, v in cache.items()})
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), **LAYER_TOL)
    for key in ("conv", "state"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **LAYER_TOL)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.mark.parametrize("jax_policy_name", ["ref", "pallas"])
def test_mamba2_forward_last_only_matches_jax(cfgs, weights,
                                              jax_policy_name):
    """Under JAX policy "pallas" the JAX side runs its SSD kernel in
    interpret mode (128 % chunk 32 == 0 passes its gate)."""
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    toks = _tokens(7, 2, 128, tcfg.vocab)
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


def test_mamba2_decode_steps_match_jax_and_forward(cfgs, weights):
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    B, S = 2, 40
    toks = _tokens(8, B, S, tcfg.vocab)
    jstate = jm.init_decode_state(jcfg, B, max_len=S)
    tstate = tm.init_decode_state(tcfg, B, max_len=S, device="cpu")
    cache = tstate["caches"]["g0_mamba"]
    assert cache["conv"].shape == (2, B, 3, 512 + 2 * 32)
    assert cache["state"].shape == (2, B, 16, 32, 32)
    assert cache["state"].dtype == torch.float32
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
    # the caches were written in place
    assert tstate["caches"]["g0_mamba"]["state"] is cache["state"]
    np.testing.assert_allclose(
        cache["state"].numpy(),
        np.asarray(jstate["caches"]["g0_mamba"]["state"]), atol=1e-5,
        rtol=1e-5)
    full, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(torch.stack(touts, 1).numpy(), full.numpy(),
                               **LOGITS_TOL)


def test_mamba2_serving_pair_matches_jax(cfgs, weights):
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    B, P = 2, 64
    toks = _tokens(9, B, P, tcfg.vocab)
    jpre = jsteps.build_prefill_step(jcfg)(jparams,
                                           {"tokens": jnp.asarray(toks)})
    tpre = tsteps.build_prefill_step(tcfg)(tparams,
                                           {"tokens": torch.from_numpy(toks)})
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
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGITS_TOL)
    assert sk.launches == 0  # CPU tensors never reach the kernel


def test_mamba2_params_convert_one_to_one(cfgs, weights):
    """Every JAX leaf is used once, with the port's own init building the
    same tree; A_log and dt_bias stay fp32 under a bf16 model."""
    jcfg, tcfg = cfgs
    jparams, tparams = weights
    jleaves = dict(paths(jax.tree.map(np.asarray, jparams)))
    tleaves = dict(paths(tparams))
    assert jleaves.keys() == tleaves.keys() == convert.param_shapes(
        tcfg).keys()
    for path, t in tleaves.items():
        np.testing.assert_array_equal(t.numpy(), jleaves[path])
    own = tm.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    assert {p: tuple(t.shape) for p, t in paths(own)} \
        == convert.param_shapes(tcfg)
    half = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                   device="cpu", dtype=torch.bfloat16)
    mixer = half["groups"]["g0_mamba"]["mixer"]
    assert mixer["A_log"].dtype == mixer["dt_bias"].dtype == torch.float32
    assert mixer["in_proj"].dtype == torch.bfloat16


def test_ssd_dispatch_raises_for_a_shape_the_kernel_cannot_take():
    """Under "auto" a CUDA-bound SSD call goes to the kernel or raises; it
    never takes the plain version quietly."""
    assert policy.select_ssd_impl((4, 512, 32, 64), 128, 256,
                                  "cuda") == "cuda"
    assert policy.select_ssd_impl((4, 512, 32, 64), 128, 256, "cpu") == "ref"
    for shape, n, chunk in (((4, 512, 32, 48), 128, 256),   # head dim
                            ((4, 512, 32, 64), 256, 256),   # d_state
                            ((4, 500, 32, 64), 128, 256)):  # s % chunk
        with pytest.raises(ValueError, match="does not take"):
            policy.select_ssd_impl(shape, n, chunk, "cuda")
    policy.set_policy("ref")
    assert policy.select_ssd_impl((4, 512, 32, 48), 128, 256,
                                  "cuda") == "ref"


@pytest.mark.parametrize("change,err", [
    (dict(p=48), ValueError),
    (dict(n=192), ValueError),
    (dict(s=96), ValueError),
    (dict(dtype=torch.float16), TypeError),
])
def test_ssd_wrapper_raises_on_an_ineligible_device_call(change, err):
    """Off the CPU the wrapper checks before it launches (meta tensors stand
    for CUDA ones here)."""
    b, s, h = 1, change.get("s", 128), 2
    p, n, dt = change.get("p", 32), change.get("n", 16), change.get(
        "dtype", torch.float32)
    meta = dict(device="meta")
    x = torch.empty((b, s, h, p), dtype=dt, **meta)
    B = torch.empty((b, s, n), dtype=dt, **meta)
    with pytest.raises(err):
        sk.ssd_scan(x, torch.empty((b, s, h), **meta),
                    torch.empty((h,), **meta), B, B, chunk=64)
    assert sk.launches == 0


def test_ssd_prepare_keeps_the_models_column_slices():
    """B and C are column slices of the convolution output in the model;
    the kernel reads them through their row stride, so prepare() hands them
    over as they are, with no copy."""
    b, s, h, p, n = 2, 64, 4, 32, 16
    rng = np.random.default_rng(7)
    conv = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * n))
                            .astype(np.float32))
    x, B, C = torch.split(conv, [h * p, n, n], dim=-1)
    dt = torch.rand((b, s, h))
    A = -torch.rand(h)
    la, xbar, kB, kC = sk.prepare(x.reshape(b, s, h, p), dt, A, B, C)
    assert kB.data_ptr() == B.data_ptr() and kC.data_ptr() == C.data_ptr()
    assert kB.stride() == B.stride() and not kB.is_contiguous()
    assert la.is_contiguous() and xbar.is_contiguous()
    assert la.dtype == torch.float32


@pytest.mark.parametrize("n,offset", [(12, 0), (16, 1)])
def test_ssd_prepare_pads_rows_the_kernel_cannot_copy(n, offset):
    """A d_state that is not a multiple of 8, or rows off a 16-byte
    boundary, are copied with n padded by zeros to a multiple of 8; the
    zero columns change neither y nor the first n columns of the state."""
    b, s, h, p, chunk = 1, 64, 2, 32, 32
    rng = np.random.default_rng(8)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, dt, A = t(b, s, h, p), torch.rand((b, s, h)), -torch.rand(h)
    BC = t(b, s, 2 * n + offset)
    B, C = BC[..., offset:offset + n], BC[..., offset + n:]
    _, _, kB, kC = sk.prepare(x, dt, A, B, C)
    n8 = -(-n // 8) * 8
    assert kB.shape == kC.shape == (b, s, n8) and kB.is_contiguous()
    assert kB.data_ptr() % 16 == 0 and kC.data_ptr() % 16 == 0
    assert torch.equal(kB[..., :n], B) and not kB[..., n:].any()
    y, st = ssd_scan_ref(x, dt, A, B, C, chunk)
    yp, stp = ssd_scan_ref(x, dt, A, kB, kC, chunk)
    torch.testing.assert_close(yp, y, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(stp[..., :n], st, atol=1e-6, rtol=1e-6)
    assert not stp[..., n:].any()
