"""The port's CUDA kernels (flash attention, SSD scan, RG-LRU scan) against
their plain versions on the card.

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


# (dtype, b, s, h, p, n, chunk, atol, rtol): the Mamba2-370M prefill shape,
# three chunks at small p and n, b > 1 with h not a multiple of 8
@pytest.mark.parametrize("dtype,b,s,h,p,n,chunk,atol,rtol", [
    (torch.float32, 4, 512, 32, 64, 128, 256, 2e-4, 5e-2),
    (torch.bfloat16, 4, 512, 32, 64, 128, 256, 2e-1, 5e-2),
    (torch.float32, 1, 192, 2, 32, 64, 64, 2e-4, 5e-2),
    (torch.float32, 3, 256, 5, 64, 128, 128, 2e-4, 5e-2),
])
def test_ssd_scan_kernel_matches_plain(cuda, dtype, b, s, h, p, n, chunk,
                                       atol, rtol):
    g = torch.Generator(device=cuda).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    x = (rnd(b, s, h, p) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A = -torch.exp(rnd(h) * 0.3)
    B, C = ((rnd(b, s, n) * 0.3).to(dtype) for _ in range(2))
    before = sk.launches
    y, st = sk.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    yr, sr = ssd_scan_ref(x.float(), dt, A, B.float(), C.float(), chunk)
    assert y.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), yr, atol=atol, rtol=rtol)
    torch.testing.assert_close(st, sr, atol=atol, rtol=rtol)


# (dtype, b, s, w, lam, atol, rtol): the RecurrentGemma-9B prefill shape, a
# ragged width, and a long sequence whose a is close to 1
@pytest.mark.parametrize("dtype,b,s,w,lam,atol,rtol", [
    (torch.float32, 4, 512, 4096, None, 1e-4, 3e-2),
    (torch.bfloat16, 4, 512, 4096, None, 1e-1, 3e-2),
    (torch.float32, 2, 300, 1000, None, 1e-4, 3e-2),
    (torch.float32, 1, 2048, 256, -9.0, 1e-4, 3e-2),
])
def test_rglru_scan_kernel_matches_plain(cuda, dtype, b, s, w, lam, atol,
                                         rtol):
    g = torch.Generator(device=cuda).manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    x = (rnd(b, s, w) * 0.5).to(dtype)
    r, i = (torch.sigmoid(rnd(b, s, w)).to(dtype) for _ in range(2))
    lam = rnd(w) * 0.5 if lam is None else torch.full((w,), lam, device=cuda)
    before = rk.launches
    y = rk.rglru_scan(x, r, i, lam)
    torch.cuda.synchronize()
    assert rk.launches == before + 1 and y.dtype == dtype
    want = rglru_ref(x.float(), r.float(), i.float(), lam)
    torch.testing.assert_close(y.float(), want, atol=atol, rtol=rtol)
