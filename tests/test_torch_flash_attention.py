"""The port's flash attention (plain version, wrapper, dispatch policy)
against the JAX package's Pallas kernel (interpret mode) and its oracle.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: fp32 ``atol=rtol=1e-5`` (the same math in another summation
order); bf16 ``atol=2e-2`` (bf16 keeps ~3 significant digits and the two
frameworks round the bf16 logits and probabilities at different points).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.ref import flash_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, policy  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _auto_policy():
    policy.set_policy("auto")
    fa.launches = 0
    yield
    policy.set_policy("auto")


def _inputs(seed, b, h, kh, sq, sk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, kh, sk, d), dtype=np.float32)
    v = rng.standard_normal((b, kh, sk, d), dtype=np.float32)
    return q, k, v


def _both(arrs, dtype):
    """The same values as torch and as jax arrays of ``dtype``."""
    t = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]
    j = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]
    return t, j


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# (dtype, B, H, K, Sq, Sk, D, causal, window)
CASES = [
    ("float32", 1, 2, 2, 128, 128, 64, True, None),     # GQA 1
    ("float32", 2, 4, 2, 256, 256, 128, True, None),    # GQA 2, D 128
    ("float32", 1, 6, 1, 128, 128, 64, False, None),    # GQA 6, non-causal
    ("float32", 1, 4, 2, 256, 256, 64, True, 32),       # sliding window
    ("float32", 1, 4, 2, 256, 128, 128, True, None),    # Sq != Sk
    ("float32", 1, 2, 1, 256, 128, 64, True, 16),       # fully-masked rows
    ("bfloat16", 1, 4, 2, 128, 128, 128, True, None),
    ("bfloat16", 1, 6, 1, 256, 256, 64, False, 64),
]


@pytest.mark.parametrize("dtype,b,h,kh,sq,sk,d,causal,window", CASES)
def test_flash_attention_ref_matches_jax(dtype, b, h, kh, sq, sk, d, causal,
                                         window):
    (tq, tk, tv), (jq, jk, jv) = _both(_inputs(0, b, h, kh, sq, sk, d), dtype)
    out = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert out.shape == (b, h, sq, d) and out.dtype == TORCH_DT[dtype]
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       interpret=True)
    oracle = jax_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(oracle), **TOL[dtype])
    # on a CPU tensor the kernel wrapper is the plain version
    np.testing.assert_array_equal(
        _np(fa.flash_attention(tq, tk, tv, causal=causal, window=window)),
        _np(out))
    assert fa.launches == 0


def test_fully_masked_rows_average_v():
    """Rows with no visible key average v over all keys (the finite -1e30
    mask), in the Pallas kernel and in the port alike."""
    q, k, v = _inputs(1, 1, 1, 1, 256, 128, 64)
    out = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                              causal=True, window=16)
    np.testing.assert_allclose(out[0, 0, 255].numpy(), v[0, 0].mean(0),
                               atol=1e-6)


def test_set_policy_rejects_unknown_policy():
    with pytest.raises(ValueError, match="unknown kernel policy"):
        policy.set_policy("pallas")
    assert policy.get_policy() == "auto"


def test_auto_policy_takes_plain_path_on_cpu():
    (tq, tk, tv), _ = _both(_inputs(2, 1, 4, 2, 128, 128, 64), "float32")
    ref = flash_attention_ref(tq, tk, tv)
    np.testing.assert_array_equal(ops.attention(tq, tk, tv).numpy(),
                                  ref.numpy())
    # the model's sdpa at a flash-eligible shape, (B, S, H, hd) layout
    y = layers.sdpa(tq.transpose(1, 2), tk.transpose(1, 2),
                    tv.transpose(1, 2), causal=True)
    np.testing.assert_allclose(y.transpose(1, 2).numpy(), ref.numpy(),
                               atol=1e-6)
    assert fa.launches == 0
    assert policy.select_attention_impl(tq.shape, tk.shape, "cpu") == "ref"


def test_cuda_policy_raises_on_cpu_tensor():
    (tq, tk, tv), _ = _both(_inputs(3, 1, 2, 1, 128, 128, 64), "float32")
    policy.set_policy("cuda")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        ops.attention(tq, tk, tv)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        layers.sdpa(tq.transpose(1, 2), tk.transpose(1, 2),
                    tv.transpose(1, 2), causal=True)
    assert fa.launches == 0


def test_ref_policy_selects_plain_version_for_cuda_shapes():
    policy.set_policy("ref")
    assert policy.select_attention_impl((1, 4, 128, 64), (1, 2, 128, 64),
                                        "cuda") == "ref"
    policy.set_policy("auto")
    assert policy.select_attention_impl((1, 4, 128, 64), (1, 2, 128, 64),
                                        "cuda") == "cuda"


@pytest.mark.parametrize("q_shape,kv_shape,ok", [
    ((4, 12, 512, 128), (4, 2, 512, 128), True),    # the main path
    ((2, 4, 128, 64), (2, 2, 128, 64), True),       # the reduced config
    ((1, 4, 100, 64), (1, 2, 37, 64), True),        # ragged tiles
    ((1, 4, 128, 96), (1, 2, 128, 96), False),      # head dim
    ((1, 6, 128, 64), (1, 4, 128, 64), False),      # GQA ratio
    ((1, 4, 128, 64), (1, 2, 128, 128), False),     # unequal head dims
    ((1, 4, 128, 64), (2, 2, 128, 64), False),      # batch
])
def test_attention_eligible(q_shape, kv_shape, ok):
    assert policy.attention_eligible(q_shape, kv_shape) is ok


def test_select_attention_impl_is_memoized_per_shape():
    key = ((1, 4, 128, 64), (1, 2, 128, 64))
    policy.select_attention_impl(*key, "cpu")
    assert (key[0], key[1], "cpu") in policy._impl_cache
    policy.set_policy("auto")
    assert not policy._impl_cache


@pytest.mark.parametrize("change,err", [
    (dict(d=96), ValueError),
    (dict(kh=3), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(window=0), ValueError),
    (dict(strided=True), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, err):
    d, kh = change.get("d", 64), change.get("kh", 2)
    dt = change.get("dtype", torch.float32)
    q = torch.zeros((1, 4, 128, d), dtype=dt)
    k = torch.zeros((1, kh, 128, d), dtype=dt)
    v = torch.zeros((1, kh, 128, d), dtype=dt)
    if change.get("strided"):
        q = torch.zeros((1, 4, 128, 2 * d))[..., ::2]
    with pytest.raises(err):
        fa.check_inputs(q, k, v, change.get("window"))
