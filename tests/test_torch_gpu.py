"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: they need an NVIDIA Hopper GPU and ``nvcc``, and skip
elsewhere.  Run them on the card with
``python -m pytest -q -m gpu tests/test_torch_gpu.py``.  This file imports
no JAX, so it also runs where JAX is not installed.
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_ref

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
