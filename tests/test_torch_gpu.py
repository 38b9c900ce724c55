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
# non-causal, and a window that bites at head dim 256.
# (d, B, H, K, Sq, Sk, causal, window)
BF16_CASES = [
    (64, 1, 2, 1, 256, 128, True, 16),
    (128, 1, 2, 1, 256, 128, True, 16),
    (256, 1, 2, 1, 256, 128, True, 16),
    (128, 1, 4, 2, 320, 200, True, None),
    (256, 1, 4, 1, 200, 333, False, None),
    (256, 1, 4, 1, 640, 640, True, 128),
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


# (dtype, b, s, h, p, n, chunk, atol, rtol, views): the Mamba2-370M prefill
# shape, three chunks at small p and n, b > 1 with h not a multiple of the
# head group, four chunks (the state pass runs three times), one chunk of
# 2048, and B and C as column slices of one tensor, as the model passes them
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
])
def test_ssd_scan_kernel_matches_plain(cuda, dtype, b, s, h, p, n, chunk,
                                       atol, rtol, views):
    g = torch.Generator(device=cuda).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    x = (rnd(b, s, h, p) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A = -torch.exp(rnd(h) * 0.3)
    if views:
        BC = (rnd(b, s, 2 * n + 16) * 0.3).to(dtype)
        B, C = BC[..., 16:16 + n], BC[..., 16 + n:]
        assert sk.prepare(x, dt, A, B, C)[2].data_ptr() == B.data_ptr()
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
