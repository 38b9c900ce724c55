"""The port's CUDA kernels (flash attention, SSD scan, RG-LRU scan) against
their plain versions on the card, and the graph-IR path on the card: B1
once per specialization class, ``embed_grad``'s ordered adds and the comm
lowering's ordered float64 fold.

Marked ``gpu``: they need an NVIDIA Hopper GPU and ``nvcc``, and skip
elsewhere.  Run them on the card with
``python -m pytest -q -m gpu tests/test_torch_gpu.py``.  This file imports
no JAX, so it also runs where JAX is not installed.
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rk
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels.ref import (flash_attention_ref, rglru_ref,
                                     ssd_scan_ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (dtype, B, H, K, Sq, Sk, D, causal, window, atol)
CASES = [
    (torch.float32, 2, 12, 2, 512, 512, 128, True, None, 1e-4),
    (torch.bfloat16, 2, 12, 2, 512, 512, 128, True, None, 2e-2),
    (torch.float32, 1, 4, 4, 200, 333, 64, False, None, 1e-4),
    (torch.float32, 1, 4, 2, 256, 128, 64, True, 16, 1e-4),
]


@pytest.mark.parametrize("dtype,b,h,kh,sq,sk,d,causal,window,atol", CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, h, kh, sq, sk,
                                              d, causal, window, atol):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, kh, sk, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, kh, sk, d), generator=g, device=cuda).to(dtype)
    q = q.transpose(1, 2)  # the strided view the model passes
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
    assert out.dtype == dtype and out.shape == (b, h, sq, d)
    assert (out.float() - want).abs().max().item() <= atol


# The tensor-core (bf16) path at every head dim: rows that see no key (Sq >
# Sk with a window of 16: rows 143.. get the mean of v), a ragged Sq != Sk,
# non-causal, and a window that bites at head dim 256.  Then each branch of
# the wgmma kernel at each head dim: a grid smaller than the card's 132 SMs
# (batch 1, 2 heads), Sq = 1 against Sk = 77, Sq < Sk and Sq > Sk causal, a
# window that bites at 64 and 128, and GQA 12/2, 16/1 and 20/20.
# (d, B, H, K, Sq, Sk, causal, window)
BF16_CASES = [
    (64, 1, 2, 1, 256, 128, True, 16),
    (128, 1, 2, 1, 256, 128, True, 16),
    (256, 1, 2, 1, 256, 128, True, 16),
    (128, 1, 4, 2, 320, 200, True, None),
    (256, 1, 4, 1, 200, 333, False, None),
    (256, 1, 4, 1, 640, 640, True, 128),
    *((d, 1, 2, 2, 512, 512, True, None) for d in (64, 128, 256)),
    *((d, 1, 2, 2, 1, 77, True, None) for d in (64, 128, 256)),
    *((d, 1, 4, 2, 100, 333, True, None) for d in (64, 128, 256)),
    *((d, 1, 4, 2, 333, 100, True, None) for d in (64, 128, 256)),
    (64, 1, 4, 2, 640, 640, True, 128),
    (128, 1, 4, 2, 640, 640, True, 128),
    (128, 2, 12, 2, 384, 384, True, None),
    (256, 2, 16, 1, 384, 384, True, None),
    (64, 2, 20, 20, 384, 384, True, None),
]


@pytest.mark.parametrize("d,b,h,kh,sq,sk,causal,window", BF16_CASES)
def test_flash_attention_bf16_tensor_cores(cuda, d, b, h, kh, sq, sk, causal,
                                           window):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=cuda)
               .to(torch.bfloat16).transpose(1, 2)
               for n, s in ((h, sq), (kh, sk), (kh, sk)))
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, sq, d)
    assert (out.float() - want).abs().max().item() <= 2e-2
    if sq > sk and window is not None:
        mean = v.float().mean(2)  # (b, kh, d)
        assert (out[:, :, -1].float() - mean.repeat_interleave(
            h // kh, 1)).abs().max().item() <= 2e-2


# q, k and v as column views of one (B, S, H, 3D) tensor, as a fused QKV
# projection gives them; two launches on the same inputs agree bit for bit
# (the schedule decides which block takes a row, never its arithmetic)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_bf16_fused_views_repeat_bitwise(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(8)
    qkv = torch.randn((2, 300, 6, 3 * d), generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[..., i * d:(i + 1) * d].transpose(1, 2) for i in range(3))
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=True)
    again = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    assert torch.equal(out, again)
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    assert (out.float() - want).abs().max().item() <= 2e-2


# DeepSeek-V2's MLA prefill: q and k at head dim 192, v at 128, 128 heads (no
# GQA), causal; k and v as column views of one (B, S, H, 320) tensor, as the
# model's split of ``wkv_b``'s output and the rope key give them
@pytest.mark.parametrize("dtype,b,h,s,atol", [
    (torch.float32, 4, 128, 512, 1e-4),
    (torch.bfloat16, 4, 128, 512, 2e-2),
    (torch.float32, 1, 4, 300, 1e-4),
    (torch.bfloat16, 1, 4, 200, 2e-2),
])
def test_flash_attention_mla_head_dims(cuda, dtype, b, h, s, atol):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((b, s, h, 192), generator=g, device=cuda).to(dtype)
    kv = torch.randn((b, s, h, 320), generator=g, device=cuda).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in (q, kv[..., :192], kv[..., 192:]))
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    assert out.dtype == dtype and out.shape == (b, h, s, 128)
    assert (out.float() - want).abs().max().item() <= atol
    # a pair the kernel is not built for raises, never falls back
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, k, kv[..., :192].transpose(1, 2))


# Each branch of the two MLA kernels (fp32: 128 query rows x 64 keys a
# tile; bf16: wgmma on TMA tiles of 128 rows x 64 keys), in both types: Sq
# and Sk off the tiles, Sq < Sk and Sq > Sk, rows that see no key under a
# window (rows 143.. get the mean of v), non-causal, a grid smaller than the
# card's 132 SMs (batch 1, 2 heads), all in the model's layout: q a
# transposed view, k and v column views of one (B, Sk, K, 320) tensor.
# (B, H, K, Sq, Sk, causal, window)
MLA_EDGE_CASES = [
    (1, 4, 2, 300, 200, True, None),
    (1, 2, 2, 1, 77, True, None),
    (1, 4, 2, 100, 333, True, None),
    (1, 4, 2, 333, 100, True, None),
    (1, 2, 1, 256, 128, True, 16),
    (1, 4, 2, 300, 333, False, None),
    (1, 2, 2, 512, 512, True, None),
]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,kh,sq,sk,causal,window", MLA_EDGE_CASES)
def test_flash_attention_mla_edges(cuda, dtype, atol, b, h, kh, sq, sk,
                                   causal, window):
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((b, sq, h, 192), generator=g, device=cuda).to(dtype)
    kv = torch.randn((b, sk, kh, 320), generator=g, device=cuda).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in (q, kv[..., :192], kv[..., 192:]))
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
    assert out.dtype == dtype and out.shape == (b, h, sq, 128)
    assert bool(torch.isfinite(out).all())
    assert (out.float() - want).abs().max().item() <= atol
    if window is not None and sq > sk:
        mean = v.float().mean(2).repeat_interleave(h // kh, 1)
        assert (out[:, :, -1].float() - mean).abs().max().item() <= atol


# RecurrentGemma-9B's local attention: head dim 256, MQA, window 2048 (which
# never bites at S = 512) and 128 (which does)
@pytest.mark.parametrize("dtype,window,s,atol", [
    (torch.float32, 2048, 512, 1e-4),
    (torch.bfloat16, 2048, 512, 2e-2),
    (torch.float32, 128, 640, 1e-4),
])
def test_flash_attention_head_dim_256(cuda, dtype, window, s, atol):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((2, s, n, 256), generator=g, device=cuda)
               .to(dtype).transpose(1, 2) for n in (16, 1, 1))
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=True,
                               window=window)
    assert (out.float() - want).abs().max().item() <= atol


def flash_fp32_digest(device, b, h, kh, s, d, window) -> str:
    """sha256 of the fp32 kernel's causal output on q, k, v drawn with numpy
    from seed 7, q in the model's transposed (B, S, H, D) layout."""
    import hashlib

    import numpy as np
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d))
                                .astype(np.float32)).to(device).transpose(1, 2)
               for n in (h, kh, kh))
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


# the generic fp32 kernel's outputs at the three main fp32 shapes (Qwen2-1.5B,
# RecurrentGemma-9B, Whisper large-v3's decoder), pinned bit for bit: the
# digests of the build before its v head dim was folded into q's, on an H100
# (the kernel is deterministic).  (B, H, K, S, D, window)
FLASH_FP32_DIGESTS = {
    (4, 12, 2, 512, 128, None):
        "31026d9b5c183448615d59e5cd3b9413c5abb7b0ba65eb3db89b9eb35c2c226d",
    (4, 16, 1, 512, 256, 2048):
        "c457decfb1e81cfbd2398b7dd45de8308e8ced98974b9c17bee3462e3e616cdb",
    (4, 20, 20, 384, 64, None):
        "481a4acad1869aa7a9cd60f1b9f6896e5c11269eaa8905c764ddcd5c53aad743",
}


@pytest.mark.parametrize("shape", list(FLASH_FP32_DIGESTS))
def test_flash_attention_fp32_output_unchanged(cuda, shape):
    assert flash_fp32_digest(cuda, *shape) == FLASH_FP32_DIGESTS[shape]


# (dtype, b, s, h, p, n, chunk, atol, rtol, views): the Mamba2-370M prefill
# shape, three chunks at small p and n, b > 1 with h not a multiple of the
# head group, four chunks (the state pass runs three times), one chunk of
# 2048, and x, B and C as slices of one tensor, as the model passes them.
# bf16 runs the tensor-core design at every one of those shapes, and at a
# ragged chunk of 100 rows (a 64-row tile and a 36-row one) with p 32, n 64
@pytest.mark.parametrize("dtype,b,s,h,p,n,chunk,atol,rtol,views", [
    (torch.float32, 4, 512, 32, 64, 128, 256, 2e-4, 5e-2, False),
    (torch.bfloat16, 4, 512, 32, 64, 128, 256, 2e-1, 5e-2, False),
    (torch.float32, 1, 192, 2, 32, 64, 64, 2e-4, 5e-2, False),
    (torch.float32, 3, 256, 5, 64, 128, 128, 2e-4, 5e-2, False),
    (torch.bfloat16, 2, 256, 5, 64, 128, 128, 2e-1, 5e-2, False),
    (torch.float32, 2, 1024, 8, 64, 128, 256, 2e-4, 5e-2, False),
    (torch.float32, 1, 2048, 4, 64, 128, 2048, 2e-4, 5e-2, False),
    (torch.float32, 2, 512, 32, 64, 128, 256, 2e-4, 5e-2, True),
    (torch.bfloat16, 2, 192, 3, 128, 96, 96, 2e-1, 5e-2, True),
    (torch.bfloat16, 1, 192, 2, 32, 64, 64, 2e-1, 5e-2, False),
    (torch.bfloat16, 3, 256, 5, 64, 128, 128, 2e-1, 5e-2, False),
    (torch.bfloat16, 2, 1024, 8, 64, 128, 256, 2e-1, 5e-2, False),
    (torch.bfloat16, 1, 2048, 4, 64, 128, 2048, 2e-1, 5e-2, False),
    (torch.bfloat16, 2, 512, 32, 64, 128, 256, 2e-1, 5e-2, True),
    (torch.bfloat16, 2, 300, 4, 32, 64, 100, 2e-1, 5e-2, False),
])
def test_ssd_scan_kernel_matches_plain(cuda, dtype, b, s, h, p, n, chunk,
                                       atol, rtol, views):
    g = torch.Generator(device=cuda).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    if views:
        # x, B and C as the model splits its convolution output
        xbc = rnd(b, s, h * p + 2 * n)
        xbc[..., :h * p] *= 0.5
        xbc[..., h * p:] *= 0.3
        xbc = xbc.to(dtype)
        x = xbc[..., :h * p].unflatten(-1, (h, p))
        B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        x = (rnd(b, s, h, p) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A = -torch.exp(rnd(h) * 0.3)
    if views:
        prep = sk.prepare(x, dt, A, B, C)
        assert prep.B.data_ptr() == B.data_ptr()
        if dtype == torch.bfloat16:
            assert prep.x.data_ptr() == x.data_ptr()
    else:
        B, C = ((rnd(b, s, n) * 0.3).to(dtype) for _ in range(2))
    before = sk.launches
    y, st = sk.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    yr, sr = ssd_scan_ref(x.float(), dt, A, B.float(), C.float(), chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr, atol=atol, rtol=rtol)
    torch.testing.assert_close(st, sr, atol=atol, rtol=rtol)


def ssd_fp32_digest(device, b, s, h, p, n, chunk) -> str:
    """sha256 of the fp32 kernel's y and final state on inputs drawn with
    numpy from seed 3 (the same bytes on any card and torch version)."""
    import hashlib

    import numpy as np
    rng = np.random.default_rng(3)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device)
    x, dt = t(b, s, h, p, scale=0.5), torch.nn.functional.softplus(t(b, s, h))
    A = -torch.exp(t(h, scale=0.3))
    B, C = t(b, s, n, scale=0.3), t(b, s, n, scale=0.3)
    y, st = sk.ssd_scan(x, dt, A, B, C, chunk=chunk)
    digest = hashlib.sha256()
    for out in (y, st):
        digest.update(out.cpu().numpy().tobytes())
    return digest.hexdigest()


# the fp32 design's outputs, pinned bit for bit: the digests of the build
# before the bf16 design was added, on an H100 (the kernel is deterministic)
SSD_FP32_DIGESTS = {
    (4, 512, 32, 64, 128, 256):
        "67c11ac05fa78f7ea7d9619a3a0bd6cd5c974f630de2a0396d05cff8445f9793",
    (1, 192, 2, 32, 64, 64):
        "8432e48e26fa085404134f231a9c5ad1693b79671eda8a171e59068487c6779d",
    (3, 256, 5, 64, 128, 128):
        "d5cb28934e8404360cc1a3fc9b2680f4577a6995fec4f639b34f776cf0de0a8b",
}


@pytest.mark.parametrize("shape", list(SSD_FP32_DIGESTS))
def test_ssd_scan_fp32_output_unchanged(cuda, shape):
    assert ssd_fp32_digest(cuda, *shape) == SSD_FP32_DIGESTS[shape]


# (dtype, b, s, w, lam, atol, rtol): the RecurrentGemma-9B prefill shape, a
# ragged width, a long sequence whose a is close to 1; in bf16 an odd width
# with a short ragged sequence (the kernel loads channel by channel) and an
# even ragged width; s = 1; s = 700, not a multiple of the fp32 kernel's
# 256-step super-chunk; and lam = -20, where a rounds to 1 and the 1e-12
# clamp of 1 - a^2 bites
RGLRU_CASES = [
    (torch.float32, 4, 512, 4096, None, 1e-4, 3e-2),
    (torch.bfloat16, 4, 512, 4096, None, 1e-1, 3e-2),
    (torch.float32, 2, 300, 1000, None, 1e-4, 3e-2),
    (torch.float32, 1, 2048, 256, -9.0, 1e-4, 3e-2),
    (torch.bfloat16, 3, 37, 1001, None, 1e-1, 3e-2),
    (torch.bfloat16, 2, 300, 1000, None, 1e-1, 3e-2),
    (torch.float32, 2, 1, 4096, None, 1e-4, 3e-2),
    (torch.bfloat16, 2, 1, 4096, None, 1e-1, 3e-2),
    (torch.float32, 2, 700, 512, None, 1e-4, 3e-2),
    (torch.float32, 2, 512, 256, -20.0, 1e-4, 3e-2),
]


def _rglru_inputs(cuda, dtype, b, s, w, lam, seed=3):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    x = (rnd(b, s, w) * 0.5).to(dtype)
    r, i = (torch.sigmoid(rnd(b, s, w)).to(dtype) for _ in range(2))
    lam = rnd(w) * 0.5 if lam is None else torch.full((w,), lam, device=cuda)
    return x, r, i, lam


@pytest.mark.parametrize("dtype,b,s,w,lam,atol,rtol", RGLRU_CASES)
def test_rglru_scan_kernel_matches_plain(cuda, dtype, b, s, w, lam, atol,
                                         rtol):
    x, r, i, lam = _rglru_inputs(cuda, dtype, b, s, w, lam)
    before = rk.launches
    y = rk.rglru_scan(x, r, i, lam)
    torch.cuda.synchronize()
    assert rk.launches == before + 1 and y.dtype == dtype
    want = rglru_ref(x.float(), r.float(), i.float(), lam)
    torch.testing.assert_close(y.float(), want, atol=atol, rtol=rtol)
    if dtype == torch.bfloat16:
        # the plain version on the same bf16 inputs rounds i x to bf16, as
        # the kernel must: then at most a few outputs differ by one rounding
        # step (an i x kept in fp32 moves ~30% of them)
        same = rglru_ref(x, r, i, lam)
        torch.testing.assert_close(y.float(), same.float(), atol=atol,
                                   rtol=rtol)
        assert (y != same).float().mean().item() <= 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_runs_one_cuda_kernel_a_call(cuda, dtype):
    """At the RecurrentGemma-9B prefill shape the wrapper forms a and b in
    the kernel: the profiler sees one CUDA kernel a call and nothing else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, r, i, lam = _rglru_inputs(cuda, dtype, 4, 512, 4096, None)
    rk.rglru_scan(x, r, i, lam)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            rk.rglru_scan(x, r, i, lam)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in kernels) == 3, [e.key for e in kernels]
    assert all("rglru_scan_kernel" in e.key for e in kernels)


@pytest.mark.parametrize("arch,par,m", [
    ("qwen2_1_5b", dict(dp=2, tp=2, pp=1), 1),
    ("llama_32b", dict(dp=1, tp=2, pp=2), 2)])
def test_graph_block_attention_runs_the_kernel_per_class(cuda, arch, par, m):
    """The graph IR's attention launches B1 (not the plain version) once
    per specialization class per layer per microbatch on the card, and
    the step trains to the port's simulator."""
    import numpy as np

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models.graph_block import block_program

    cfg = get_config(arch).reduced()
    b, s = 2, 128
    rng = np.random.default_rng(0)
    feeds = {"ids": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    prog = block_program(cfg, batch=b, seq=s, **par)
    ws = {t.name: np.ones(t.shape, np.float32)
          if "norm" in t.name.split("/")[-1]
          else (rng.standard_normal(t.shape) * 0.05).astype(np.float32)
          for t in prog.graph.parameters()}
    results = {}
    for ex in (api.SimulatorExecutor(), api.TorchExecutor()):
        sess = api.Session(prog, 0, executor=ex)
        sess.load(ws)
        before = fa.launches
        results[ex.name] = sess.train_step(dict(feeds), num_microbatches=m)
        launched = fa.launches - before
    tplan = prog.compile_train(0, num_microbatches=m)
    lw = ex.lowered(tplan, [tplan.loss_name] + [
        tplan.grad_map[t.name] for t in tplan.graph.parameters()], m)
    assert lw.stats.kernel_dispatches == cfg.n_layers
    assert lw.stats.ref_dispatches == 0
    assert launched == lw.stats.kernel_dispatches * m == cfg.n_layers * m
    want, got = results["sim"], results["torch"]
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5, atol=1e-9)
    for n in ws:
        np.testing.assert_allclose(got.grad_value(n), want.grad_value(n),
                                   atol=1e-6, rtol=2e-4, err_msg=n)


def test_embed_grad_adds_duplicates_in_np_add_at_order_on_the_card(cuda):
    """``index_add_`` alone sums duplicate rows in no fixed order on the
    GPU; the port adds them first occurrence first, as ``np.add.at``
    does, bit for bit on non-integer rows."""
    import numpy as np

    from repro_torch.runtime import torch_ops

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, (4096,)).astype(np.int32)
    dy = rng.standard_normal((4096, 64)).astype(np.float32)
    want = np.zeros((50, 64), np.float32)
    np.add.at(want, ids, dy)
    got = torch_ops.local_apply(
        "embed_grad", [torch.from_numpy(dy).to(cuda),
                       torch.from_numpy(ids).to(cuda)], {}, (50, 64))
    assert got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("kind,n", [("AR", 4), ("AR", 8), ("RS", 8)])
def test_exact_reduction_folds_in_srcs_order_on_the_card(cuda, kind, n):
    """Summands that cancel (1e17, -1e17 and small values in a random
    order per element): the card's float64 fold must follow ``srcs``
    order to equal the simulator bit for bit."""
    import numpy as np

    from repro_torch import api
    from repro_torch.core.annotations import DS, DUP, PARTIAL, spmd
    from repro_torch.core.simulator import scatter

    def cancelling(value, k, rng):
        big = np.full(value.shape, 1e17, value.dtype)
        pieces = np.stack([big, -big] + [
            rng.normal(size=value.shape).astype(value.dtype)
            for _ in range(k - 2)])
        return list(rng.permuted(pieces, axis=0))

    src = spmd(range(n), DS({PARTIAL: n}))
    dst = spmd(range(n), DS({DUP: n} if kind == "AR" else {0: n}))
    st = scatter(np.zeros((64, 32), np.float32), src,
                 rng=np.random.default_rng(5), decompose=cancelling)
    g = api.Graph()
    g.placeholder("X", (64, 32))
    g.comm(g.tensors["X"], name="Y")
    prog = api.Program(g, [api.Strategy("s", {"X": src, "Y": dst})])
    outs = {ex.name: api.Session(prog, "s", executor=ex).run(
        {"X": st}).shards("Y")
        for ex in (api.SimulatorExecutor(), api.TorchExecutor())}
    for dev, arr in outs["sim"].parts.items():
        assert np.array_equal(outs["torch"].parts[dev], arr), dev


def _leaf(t):
    return t.detach().clone().requires_grad_()


def _grad_cases(cuda):
    """(name, kernel module, with_grad call, plain call, leaves): the
    training path's shapes at one microbatch of 4 x 512 -- B1 at Qwen2-1.5B's
    D=128, RecurrentGemma-9B's D=256 (window 2048) and DeepSeek-V2's MLA
    (q / k 192, v 128; 16 of its 128 heads), B2 at Mamba2-370M's,
    B3 at RecurrentGemma-9B's -- fp32, each input a leaf that needs a
    gradient (dt and A through the model's own softplus and -exp)."""
    g = torch.Generator(device=cuda).manual_seed(6)

    def rnd(*shape, scale=1.0):
        return _leaf(torch.randn(shape, generator=g, device=cuda) * scale)
    F = torch.nn.functional
    cases = []
    for name, d, dv, h, kh, window in (
            ("flash D128", 128, 128, 12, 2, None),
            ("flash D256", 256, 256, 16, 1, 2048),
            ("flash D192/128", 192, 128, 16, 16, None)):
        q = _leaf(rnd(4, 512, h, d).transpose(1, 2))
        k, v = rnd(4, kh, 512, d), rnd(4, kh, 512, dv)
        kw = dict(causal=True, window=window)
        cases.append((name, fa,
                      lambda q, k, v, kw=kw: fa.flash_attention_with_grad(
                          q, k, v, **kw),
                      lambda q, k, v, kw=kw: flash_attention_ref(q, k, v,
                                                                 **kw),
                      [q, k, v]))
    x = rnd(4, 512, 32, 64, scale=0.5)
    dt_raw, a_log = rnd(4, 512, 32), rnd(32, scale=0.3)
    BC = rnd(4, 512, 256, scale=0.3)

    def ssd_args(x, dt_raw, a_log, BC):
        return (x, F.softplus(dt_raw), -torch.exp(a_log), BC[..., :128],
                BC[..., 128:])
    cases.append(("ssd", sk,
                  lambda *a: sk.ssd_scan_with_grad(*ssd_args(*a), chunk=256),
                  lambda *a: ssd_scan_ref(*ssd_args(*a), 256),
                  [x, dt_raw, a_log, BC]))
    xr, r_raw, i_raw = (rnd(4, 512, 4096, scale=0.5) for _ in range(3))
    lam = rnd(4096, scale=0.5)

    def rg_args(x, r_raw, i_raw, lam):
        return x, torch.sigmoid(r_raw), torch.sigmoid(i_raw), lam
    cases.append(("rglru", rk,
                  lambda *a: rk.rglru_scan_with_grad(*rg_args(*a)),
                  lambda *a: rglru_ref(*rg_args(*a)),
                  [xr, r_raw, i_raw, lam]))
    return cases


@pytest.mark.parametrize("which", ["flash D128", "flash D256",
                                   "flash D192/128", "ssd", "rglru"])
def test_kernel_function_forward_and_grads_on_the_card(cuda, which):
    """On CUDA tensors that need a gradient, each kernel's Function returns
    an output with a ``grad_fn``; its forward launches the kernel once (and
    agrees with the plain version within the kernel's tolerance), its
    backward launches none, and its gradients equal plain autograd's on the
    same inputs (the backward is the plain version, recomputed from the
    saved inputs; rtol 1e-5, atol 1e-7 leave room for cuBLAS choosing
    another reduction order between the two calls)."""
    (name, mod, run, plain, leaves), = [
        c for c in _grad_cases(cuda) if c[0] == which]
    before = mod.launches
    out = run(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    assert all(o.grad_fn is not None for o in outs)
    want = plain(*leaves)
    wants = want if isinstance(want, tuple) else (want,)
    tol = (2e-4, 5e-2) if name == "ssd" else (1e-4, 3e-2)
    for o, w in zip(outs, wants):
        torch.testing.assert_close(o, w.detach(), atol=tol[0], rtol=tol[1])
    gen = torch.Generator(device=cuda).manual_seed(7)
    seeds = [torch.randn(o.shape, generator=gen, device=cuda) for o in outs]
    got = torch.autograd.grad(outs, leaves, seeds)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    ref = torch.autograd.grad(wants, leaves, seeds)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_train_step_runs_every_kernel_forward_and_recompute(cuda, arch):
    """A reduced model's training step (batch 4, seq 128, 2 microbatches,
    remat) on the card: each kernel launches layers x microbatches x 2
    times (forward and recompute), and the step agrees with the same step
    through the plain versions (loss rel 1e-5, every gradient within
    normwise 1e-4 of the plain path's)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import policy
    from repro_torch.models.model import init_params
    from repro_torch.train.steps import accumulate_grads
    cfg = get_config(arch).reduced()
    per_kind = {"qwen2-1.5b": {"flash": 2},
                "mamba2-370m": {"ssd": 2},
                "recurrentgemma-9b": {"rglru": 2, "flash": 1}}[arch]
    mods = {"flash": fa, "ssd": sk, "rglru": rk}
    rng = torch.Generator(device=cuda).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 128), generator=rng,
                                     device=cuda)}
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    results = {}
    for pol in ("auto", "ref"):
        policy.set_policy(pol)
        try:
            params = init_params(cfg, device=cuda, generator=torch.Generator(
                device=cuda).manual_seed(0))
            before = {k: m.launches for k, m in mods.items()}
            results[pol] = accumulate_grads(params, batch, cfg, 2)
            torch.cuda.synchronize()
            got = {k: m.launches - before[k] for k, m in mods.items()}
        finally:
            policy.set_policy("auto")
        want = {k: per_kind.get(k, 0) * 2 * 2 if pol == "auto" else 0
                for k in mods}
        assert got == want, pol
    (loss, grads), (ploss, pgrads) = results["auto"], results["ref"]
    assert abs(loss.item() - ploss.item()) <= 1e-5 * abs(ploss.item())
    from repro_torch.tree import tree_leaves
    for a, b in zip(tree_leaves(grads), tree_leaves(pgrads)):
        assert (a - b).norm() <= 1e-4 * b.norm() + 1e-12


@pytest.mark.parametrize("dst_kind", ["pp", "hetero"])
def test_session_switch_on_the_card_matches_the_simulator(cuda, dst_kind):
    """The elastic probe trained two steps under dp over four virtual
    devices, then switched: a ``TorchExecutor`` session on the card
    migrates weights and AdamW m/v through the torch comm lowering
    (``backend="torch"``), every shard bitwise what the port's numpy
    ``SimulatorExecutor`` session holds after the same switch."""
    from repro_torch import api
    from repro_torch.elastic import fixtures as fix
    sessions = []
    for ex in (api.SimulatorExecutor(), api.TorchExecutor()):
        prog = api.Program(fix.probe_graph(),
                           [fix.probe_layout([0, 1, 2, 3], "dp")])
        sess = api.Session(prog, 0, executor=ex)
        sess.load(fix.probe_values())
        for step in range(2):
            sess.train_step(fix.probe_feeds(step))
        report = sess.switch(fix.probe_layout([0, 1, 2, 3], dst_kind))
        sessions.append((sess, report))
    (sim, srep), (card, crep) = sessions
    assert crep.message_count == srep.message_count
    assert "move" in crep.execute_seconds and not srep.execute_seconds
    for key in ("weights", "m", "v"):
        want = sim.weights if key == "weights" else sim.opt_state[key]
        got = card.weights if key == "weights" else card.opt_state[key]
        for name, st in want.items():
            assert got[name].parts.keys() == st.parts.keys()
            for dev, part in st.parts.items():
                assert (got[name].parts[dev] == part).all(), (key, name, dev)


def _llama_pipeline(m):
    """Reduced Llama blocks under tp2 x pp2 (batch 4, seq 128): the micro
    train plan, its fetches (the loss and every gradient) and the
    per-microbatch leaf states, as ``Session`` builds them."""
    import numpy as np

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models.graph_block import block_program

    cfg = get_config("llama_32b").reduced()
    rng = np.random.default_rng(0)
    feeds = {k: rng.integers(0, cfg.vocab, (4, 128)).astype(np.int32)
             for k in ("ids", "labels")}
    prog = block_program(cfg, batch=4, seq=128, dp=1, tp=2, pp=2)
    sess = api.Session(prog, 0, executor=api.SimulatorExecutor())
    sess.load({t.name: np.ones(t.shape, np.float32)
               if "norm" in t.name.split("/")[-1]
               else (rng.standard_normal(t.shape) * 0.05).astype(np.float32)
               for t in prog.graph.parameters()})
    tplan = prog.compile_train(0, num_microbatches=m)
    states = [dict(sess.weights) for _ in range(m)]
    for t in tplan.graph.placeholders():
        pieces = np.split(feeds[t.name], m, axis=tplan.mb_roles[t.name])
        for st, piece in zip(states, pieces):
            st[t.name] = api.scatter(piece, t.annots[0],
                                     rng=np.random.default_rng(0))
    fetches = [tplan.loss_name] + [tplan.grad_map[t.name]
                                   for t in tplan.graph.parameters()]
    return cfg, tplan, fetches, states


def _assert_runs_equal(want, got, what):
    import numpy as np
    for j, (a, b) in enumerate(zip(want, got)):
        for name, st in a.items():
            for dev, part in st.parts.items():
                assert np.array_equal(b[name].parts[dev], part), \
                    (what, j, name, dev)


def test_async_matches_torch_executor_on_the_card(cuda, monkeypatch):
    """Reduced Llama tp2 x pp2, 4 microbatches, 1f1b: the async executor
    (each virtual stage on its own stream) and its serialized baseline
    give the loss and every gradient shard bit for bit as
    ``TorchExecutor``; B1 launches once per attention class per
    microbatch, each on the stream of the stage that runs it."""
    from repro_torch import api
    from repro_torch.core.schedule import build_schedule

    cfg, tplan, fetches, states = _llama_pipeline(4)
    sched = build_schedule(2, 4, "1f1b")
    want = api.TorchExecutor().run_schedule(tplan, sched, states, fetches)
    streams = []
    launch = fa.flash_attention

    def spy(*args, **kw):
        streams.append(torch.cuda.current_stream())
        return launch(*args, **kw)
    monkeypatch.setattr(fa, "flash_attention", spy)
    for serialize in (False, True):
        ex = api.AsyncExecutor(serialize=serialize)
        lw = ex.lowered(tplan, fetches)
        streams.clear()
        before = fa.launches
        got = ex.run_schedule(tplan, sched, states, fetches)
        torch.cuda.synchronize()
        _assert_runs_equal(want, got, f"serialize={serialize}")
        assert lw.stats.kernel_dispatches == cfg.n_layers
        assert lw.stats.ref_dispatches == 0
        assert fa.launches - before == lw.stats.kernel_dispatches * 4
        # one layer a stage: each stage's stream launches B1 once a
        # microbatch, in its forward
        assert len(streams) == 8
        for s in lw._streams[:2]:
            assert sum(x == s for x in streams) == 4


def test_async_stream_hazard_stress(cuda):
    """The same pipelined step 20 times, the caching allocator churned
    between runs on the caller's stream and on a side stream: every run's
    loss and gradients bitwise the first's.  A tensor freed on its
    producer's stream while another stream still reads it would show
    here as a run that differs."""
    from repro_torch import api
    from repro_torch.core.schedule import build_schedule

    _, tplan, fetches, states = _llama_pipeline(4)
    sched = build_schedule(2, 4, "1f1b")
    ex = api.AsyncExecutor()
    first = ex.run_schedule(tplan, sched, states, fetches)
    side = torch.cuda.Stream()
    g = torch.Generator(device=cuda).manual_seed(8)
    for i in range(19):
        junk = [torch.randn((1 << (10 + i % 8),), generator=g, device=cuda)
                for _ in range(8)]
        with torch.cuda.stream(side):
            junk += [torch.full((3 << (8 + i % 5),), float(i), device=cuda)
                     for _ in range(8)]
        got = ex.run_schedule(tplan, sched, states, fetches)
        del junk
        _assert_runs_equal(first, got, f"run {i + 2}")


def test_rank_sweep_sharing_the_card_matches_the_simulator(cuda):
    """The rank selftest's comm sweep (every CommStep kind, exact and
    integer shards, round trips) at 2 ranks sharing the card over gloo:
    each rank holds every case bitwise against the port's simulator, and
    every payload was staged through host memory."""
    import json

    from repro_torch.runtime.harness import run_ranks

    procs = run_ranks("repro_torch.runtime.selftest", 2, backend="gloo",
                      device="cuda", timeout=180,
                      extra_args=["--cases", "comm"])
    line = next(x for x in procs[0].stdout.splitlines()
                if x.startswith("RUNTIME_SELFTEST_JSON "))
    report = json.loads(line.split(" ", 1)[1])
    assert report["ok"], {k: c.get("error")
                          for k, c in report["cases"].items()
                          if not c["ok"]}
    assert (report["device"], report["ranks"]) == ("cuda", 2)
    assert len(report["cases"]) == 21
    moved = [c for c in report["cases"].values()
             if c.get("p2p_messages") or c.get("collectives")]
    assert moved and all(c["staged_bytes"] > 0 for c in moved)


# phase 5's Qwen2-1.5B block under dp2 x tp2 (batch 4, seq 512): each
# device's local GEMMs, (rows, k) @ (k, n) with rows = batch 2 x seq 512
# in the forward and k = 2 x 512 for a weight gradient
BLOCK_GEMMS = {
    "wq": ((2, 512, 1536), (1536, 768)),
    "wk": ((2, 512, 1536), (1536, 128)),
    "wo": ((2, 512, 768), (768, 1536)),
    "w_up": ((2, 512, 1536), (1536, 4480)),
    "w_down": ((2, 512, 4480), (4480, 1536)),
    "lm_head": ((2, 512, 1536), (1536, 75968)),
    "grad wq": ((1536, 1024), (1024, 768)),
    "grad w_down": ((4480, 1024), (1024, 1536)),
}


@pytest.mark.parametrize("name", sorted(BLOCK_GEMMS))
def test_block_gemm_one_row_against_four_rows_folded(cuda, name):
    """One specialization class's GEMM of phase 5's block, through the
    stacked executor's ``torch_ops.stacked_apply``, over the four devices'
    rows at once (``TorchExecutor``) and over each row alone (a rank of
    ``DistExecutor``), TF32 off.  The rows agree to fp32 rounding; the
    test prints whether they come out bitwise equal (the question why the
    rank run leaves phase 5's bits)."""
    from repro_torch.runtime import torch_ops

    assert not torch.backends.cuda.matmul.allow_tf32
    a_shape, b_shape = BLOCK_GEMMS[name]
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((4,) + a_shape, generator=gen, device=cuda)
    b = torch.randn((4,) + b_shape, generator=gen, device=cuda) * 0.05
    out_shape = a_shape[:-1] + b_shape[-1:]
    folded = torch_ops.stacked_apply("dot", [a, b], {}, out_shape, 4, cuda)
    rows = torch.cat([torch_ops.stacked_apply("dot", [a[r:r + 1],
                                                      b[r:r + 1]], {},
                                              out_shape, 1, cuda)
                      for r in range(4)])
    bitwise = [torch.equal(folded[r], rows[r]) for r in range(4)]
    diff = (folded - rows).abs().max().item()
    print(f"\nGEMM {name} {a_shape} @ {b_shape} on "
          f"{torch.cuda.get_device_name(0)}: one row vs four folded, "
          f"bitwise per row {bitwise}, max |diff| {diff:.3e}")
    torch.testing.assert_close(rows, folded, rtol=1e-5, atol=1e-5)
