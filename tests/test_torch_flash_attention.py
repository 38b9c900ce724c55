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

from repro.kernels import policy as jax_policy  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.ref import flash_attention_ref as jax_ref  # noqa: E402
from repro.models.layers import sdpa as jax_sdpa  # noqa: E402
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
    # the card's bf16 kernel is held to this plain version at head dims 128
    # and 256 too: a window that bites at 256, non-causal, and Sq != Sk
    ("bfloat16", 1, 2, 1, 256, 256, 256, True, 128),
    ("bfloat16", 1, 4, 1, 128, 128, 256, False, None),
    ("bfloat16", 1, 4, 2, 256, 128, 128, True, None),
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


# MLA's pair, q and k at 192 with v at 128: the port's plain version, which
# the card holds both MLA kernels to, against the JAX model's plain ``sdpa``
# (what the reference runs for MLA: its Pallas kernel sizes v by q's D).
# (dtype, B, H, K, Sq, Sk, causal, window)
MLA_CASES = [
    ("float32", 1, 4, 4, 128, 128, True, None),     # causal, no GQA
    ("float32", 1, 4, 2, 96, 160, True, None),      # ragged, Sq < Sk
    ("float32", 1, 4, 2, 160, 96, True, None),      # ragged, Sq > Sk
    ("float32", 1, 4, 2, 100, 77, False, None),     # non-causal
    ("float32", 1, 2, 1, 256, 128, True, 16),       # fully-masked rows
    ("bfloat16", 1, 4, 4, 128, 128, True, None),
    ("bfloat16", 1, 4, 2, 160, 96, True, None),
    ("bfloat16", 1, 2, 1, 256, 128, True, 16),
]


@pytest.mark.parametrize("dtype,b,h,kh,sq,sk,causal,window", MLA_CASES)
def test_mla_ref_matches_jax_sdpa(dtype, b, h, kh, sq, sk, causal, window):
    rng = np.random.default_rng(5)
    # the model's layout, (B, S, heads, head dim)
    arrs = [rng.standard_normal(shape, dtype=np.float32) for shape in
            ((b, sq, h, 192), (b, sk, kh, 192), (b, sk, kh, 128))]
    (tq, tk, tv), (jq, jk, jv) = _both(arrs, dtype)
    was = jax_policy.get_policy()
    jax_policy.set_policy("ref")
    try:
        want = jax_sdpa(jq, jk, jv, causal=causal, window=window)
    finally:
        jax_policy.set_policy(was)
    out = flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=causal,
                              window=window)
    assert out.shape == (b, h, sq, 128) and out.dtype == TORCH_DT[dtype]
    np.testing.assert_allclose(_np(out.transpose(1, 2)), _np(want),
                               **TOL[dtype])
    if window is not None and sq > sk:
        # rows 143.. see no key: both give the mean of v over all keys
        np.testing.assert_allclose(_np(out[0, :, -1]),
                                   _np(tv[0, :, 0].float().mean(0))[None]
                                   .repeat(h, 0), **TOL[dtype])
    np.testing.assert_array_equal(
        _np(fa.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                               tv.transpose(1, 2), causal=causal,
                               window=window)), _np(out))
    assert fa.launches == 0


def test_rows_aligned_copies_what_the_kernels_cannot_address():
    """The wrapper hands the kernels every tensor as it is when its rows
    start on 16 bytes and its strides are positive, and a contiguous copy
    otherwise: a broadcast (stride-0) head dim, which the bf16 kernel's
    TMA maps cannot describe, or a row start off 16 bytes."""
    kv = torch.randn((2, 64, 3, 320), dtype=torch.bfloat16)
    v = kv[..., 192:].transpose(1, 2)  # the model's column view of v
    assert fa._rows_aligned(v) is v
    one = torch.randn((2, 64, 1, 192)).transpose(1, 2)  # extent-1 heads
    assert fa._rows_aligned(one) is one
    wide = one.expand(2, 4, 64, 192)    # a broadcast head dim
    got = fa._rows_aligned(wide)
    assert got.stride(1) > 0 and got.is_contiguous()
    torch.testing.assert_close(got, wide, rtol=0, atol=0)
    odd = torch.randn((1, 2, 64, 200))[..., 4:196]  # rows start at 16 B + 16
    assert fa._rows_aligned(odd) is odd
    off = torch.randn((1, 2, 64, 200))[..., 2:194]  # 8 bytes off
    got = fa._rows_aligned(off)
    assert got is not off and got.data_ptr() % 16 == 0
    torch.testing.assert_close(got, off, rtol=0, atol=0)


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
    ((4, 128, 512, 192), (4, 128, 512, 192), False),  # MLA's q/k, v at 192
    ((1, 4, 128, 64), (2, 2, 128, 64), False),      # batch
])
def test_attention_eligible(q_shape, kv_shape, ok):
    assert policy.attention_eligible(q_shape, kv_shape) is ok


@pytest.mark.parametrize("k_d,v_d,ok", [
    (192, 128, True),      # DeepSeek-V2's MLA: qk_nope 128 + rope 64, v 128
    (192, 192, False),
    (128, 192, False),
    (64, 128, False),
    (256, 128, False),
])
def test_attention_eligible_reads_v_head_dim(k_d, v_d, ok):
    q, k, v = (4, 128, 512, k_d), (4, 128, 512, k_d), (4, 128, 512, v_d)
    assert policy.attention_eligible(q, k, v) is ok
    assert policy.attention_eligible(q, k, (4, 128, 256, v_d)) is False
    if ok:
        assert policy.select_attention_impl(q, k, "cuda", v) == "cuda"
    else:
        with pytest.raises(ValueError, match="does not take"):
            policy.select_attention_impl(q, k, "cuda", v)


def test_select_attention_impl_is_memoized_per_shape():
    key = ((1, 4, 128, 64), (1, 2, 128, 64))
    policy.select_attention_impl(*key, "cpu")
    assert (key[0], key[1], key[1], "cpu") in policy._impl_cache
    policy.set_policy("auto")
    assert not policy._impl_cache


def test_wrapper_takes_mla_head_dims_and_gives_v_head_dim():
    """q and k at 192 with v at 128 pass the checks; on the CPU the
    wrapper runs the plain version, whose output has v's head dim and
    whose scale is q's 1/sqrt(192)."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 4, 128, 192), generator=g)
    k = torch.randn((1, 2, 128, 192), generator=g)
    v = torch.randn((1, 2, 128, 128), generator=g)
    fa.check_inputs(q, k, v, None)
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.shape == (1, 4, 128, 128)
    logits = torch.einsum("bhqd,bhkd->bhqk", q,
                          k.repeat_interleave(2, 1)) / 192 ** 0.5
    mask = torch.ones(128, 128, dtype=torch.bool).tril()
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(
        logits.masked_fill(~mask, -1e30), -1), v.repeat_interleave(2, 1))
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("change,err", [
    (dict(d=96), ValueError),
    (dict(kh=3), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(window=0), ValueError),
    (dict(strided=True), ValueError),
    (dict(dv=96), ValueError),
    (dict(d=192, dv=192), ValueError),
    (dict(vs=64), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, err):
    d, kh = change.get("d", 64), change.get("kh", 2)
    dt = change.get("dtype", torch.float32)
    q = torch.zeros((1, 4, 128, d), dtype=dt)
    k = torch.zeros((1, kh, 128, d), dtype=dt)
    v = torch.zeros((1, kh, change.get("vs", 128), change.get("dv", d)),
                    dtype=dt)
    if change.get("strided"):
        q = torch.zeros((1, 4, 128, 2 * d))[..., ::2]
    with pytest.raises(err):
        fa.check_inputs(q, k, v, change.get("window"))
