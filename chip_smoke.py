#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 off.
2. build: every kernel of the port from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all at once, with ptxas's register and spill report.
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the main paths' shapes and at edge cases: flash attention
   (head dims 64, 128 and 256), the SSD scan (y and the final state) and
   the RG-LRU scan (bf16 cases also against the plain version on the same
   bf16 inputs, output for output).  At the main shapes it times the
   kernel's wrapper, the kernels alone where the wrapper prepares their
   inputs (the SSD scan), the plain version, the bound, and one library
   call where one computes the same function
   (``scaled_dot_product_attention``, a yardstick the port never calls).
   Times are device times (calls captured in a CUDA graph and replayed);
   the wrapper's time issued from Python call by call stands beside.  The
   RG-LRU wrapper must run exactly one CUDA kernel a call (``torch.profiler``)
   and its kernel must build without spills.
4. serve: full-width, full-depth Qwen2-1.5B (28 layers), then Mamba2-370M
   (48 layers) and RecurrentGemma-9B (38 layers), each fp32 with random
   weights from seed 0 and freed before the next, each answering 4 prompts
   of 512 tokens and generating 32 tokens each.  The kernel counts are set
   to 0 just before each model's run and read just after; prefill must
   launch each kernel once per layer that holds it (flash 28 for Qwen, SSD
   48 for Mamba2, RG-LRU 26 and flash 12 for RecurrentGemma) and decode
   none, the teacher-forced decode logits must agree with prefill's, and
   prefill must agree with the plain path (policy ``ref``) on the card.
   Then "where the time goes" for each model.
5. graph-IR training (``block_program`` -> ``Program.compile_train`` ->
   ``Session.train_step`` -> ``TorchExecutor``): full-width Qwen2-1.5B
   blocks (2 layers, batch 4, seq 512, weights from seed 0 with numpy)
   under dp2 x tp2, four virtual devices stacked as rows on the one GPU,
   three steps.  B1 must launch once per layer per step (the wrapper's
   count, against the lowered graph's layers x attention classes), step
   1's loss and every gradient must agree with the port's
   ``SimulatorExecutor`` run in numpy on the host at the same size (loss
   rtol 1e-5, gradients atol 1e-6 and rtol 2e-4 as ``tests/test_archs.py``
   holds the graph IR, and each gradient's normwise relative error at most
   2e-4, the key biases' excepted: at the full vocabulary every gradient
   lies below that atol, and the key-bias gradient is zero), and
   the loss must be finite and change from step to step.  Then where the
   step's time goes (host clock with the device synchronized at each
   boundary, and ``torch.profiler``), peak memory, and B1 at this path's
   shape against its plain version, its bound and SDPA.  Last, reduced
   Llama under tp2 x pp2 with two microbatches (1f1b): B1 once per layer
   per microbatch, and the same agreement with the simulator.
6. the kernels line, then the card line, then the result line.

Needs a visible CUDA device and the repository's ``src/`` beside it; it
imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the
#: tensor cores, bf16 on the tensor cores, HBM3 bandwidth.  A bound takes
#: the rate of the inputs' type, whatever the kernel computes in.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: (atol, rtol) of the scans, as tests/test_kernels.py holds the Pallas
#: kernels to their oracles
SSD_TOL = {"float32": (2e-4, 5e-2), "bfloat16": (2e-1, 5e-2)}
RGLRU_TOL = {"float32": (1e-4, 3e-2), "bfloat16": (1e-1, 3e-2)}
#: the largest share of bf16 RG-LRU outputs that may differ from the plain
#: version on the same bf16 inputs.  Both round i x to bf16 and scan in
#: fp32 in other orders, so a few outputs land on the other side of a bf16
#: rounding step (~0.03% in a CPU simulation); an i x kept in fp32 moves
#: ~30% of them.
RGLRU_BF16_MISMATCH = 0.01
ARCHS = ("qwen2-1.5b", "mamba2-370m", "recurrentgemma-9b")
BATCH, PROMPT, GEN = 4, 512, 32
#: phase 5: graph-IR training of full-width Qwen2-1.5B blocks
IR_LAYERS, IR_BATCH, IR_SEQ = 2, 4, 512
#: step 1 against the simulator: the tolerance ``tests/test_archs.py``
#: holds the graph IR's loss and gradients to ...
LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-6, 2e-4
#: ... and, because at the full 151936-token vocabulary every gradient
#: lies below that atol (the loss is a mean of probabilities near 1/vocab),
#: a normwise bound on each gradient's relative error as well (key biases
#: excepted: their gradient is mathematically zero)
GRAD_NORM_RTOL = 2e-4


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def ptxas_report(log: str):
    """(kernel, registers, spill store bytes, spill load bytes) for each
    kernel in an ``nvcc -Xptxas=-v`` log, in order."""
    import re
    out, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), *spill))
            fn, spill = None, (0, 0)
    return out


def eager_ms(fn, iters=20, warmup=3) -> float:
    """Time of one call of fn issued from Python, back to back: CUDA events
    around ``iters`` calls.  Where the host takes longer to issue a call
    than the card to run it, this is the host's time."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


_capture_stream = None


def time_ms(fn, iters=20, warmup=3, replays=3) -> float:
    """Device time of one call of fn: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    cost of issuing each call is left out.  Warm-up and capture share one
    side stream for the whole run (cuBLAS keeps a workspace per stream)."""
    import torch
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    side = _capture_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (iters * replays)


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The larger of operations over the peak rate of ``dtype`` and bytes
    over the memory rate, in ms, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_bound_ms(q, k, causal, window) -> tuple[float, str]:
    """Least time on the card: the visible (q, k) pairs' 4*D flops at the
    peak rate of the inputs' type against q, k, v, o moved once."""
    import torch
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qi = torch.arange(sq)[:, None]
    ki = torch.arange(sk)[None, :]
    vis = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        vis &= ki <= qi
    if window is not None:
        vis &= ki > qi - window
    flops = 4.0 * b * h * d * int(vis.sum())
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return bound(flops, nbytes, str(q.dtype).removeprefix("torch."))


def ssd_bound_ms(b, s, h, p, n, chunk, dtype, es,
                 kernel_only=False) -> tuple[float, str]:
    """The chunked scan's least work: per (b, chunk) C B^T on the causal
    half once (it is the same for every head), per (b, h, chunk) the masked
    product with xbar on the causal half, C S^T and the state update, 2
    flops a multiply-add.  Bytes: the function's inputs read once (x, B, C
    in ``dtype``; dt, A fp32) and y and the fp32 state written once; for
    the kernel alone la (fp32) and xbar stand for dt, A and x."""
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    flops = 2.0 * b * nc * tri * n + 2.0 * b * h * nc * (
        tri * p + 2 * chunk * n * p)
    nbytes = es * (2 * b * s * h * p + 2 * b * s * n) + 4 * (
        b * s * h + b * h * p * n + (0 if kernel_only else h))
    return bound(flops, nbytes, dtype)


def rglru_bound_ms(b, s, w, dtype, es):
    """Bytes: the function reads x, r, i (in ``dtype``) and lam and writes
    y.  Its flops (a dozen elementwise ones per element) weigh nothing
    beside."""
    return bound(12.0 * b * s * w, es * 4 * b * s * w + 4 * w, dtype)


def attention_cases():
    """(name, dtype, B, H, K, Sq, Sk, D, causal, window, layout); names
    starting with "main" are timed."""
    return [
        ("main fp32", "float32", 4, 12, 2, 512, 512, 128, True, None, "bshd"),
        ("main bf16", "bfloat16", 4, 12, 2, 512, 512, 128, True, None,
         "bshd"),
        ("head dim 64", "float32", 2, 4, 2, 512, 512, 64, True, None, "bhsd"),
        ("GQA 1", "float32", 2, 4, 4, 384, 384, 128, True, None, "bhsd"),
        ("window 128", "float32", 2, 12, 2, 512, 512, 128, True, 128, "bhsd"),
        ("Sq != Sk, ragged", "float32", 1, 4, 2, 320, 200, 64, True, None,
         "bhsd"),
        ("Sq < Sk, non-causal", "bfloat16", 1, 6, 2, 100, 300, 64, False,
         None, "bhsd"),
        ("fully-masked rows", "float32", 1, 2, 1, 256, 128, 64, True, 16,
         "bhsd"),
        ("main D256 fp32", "float32", 4, 16, 1, 512, 512, 256, True, 2048,
         "bshd"),
        ("main D256 bf16", "bfloat16", 4, 16, 1, 512, 512, 256, True, 2048,
         "bshd"),
        ("D256 window 128", "float32", 1, 4, 1, 640, 640, 256, True, 128,
         "bshd"),
        # the tensor-core path: each head dim with fully-masked rows, a
        # ragged Sq != Sk, non-causal, and a window that bites at D = 256
        ("fully-masked rows D64", "bfloat16", 1, 2, 1, 256, 128, 64, True,
         16, "bhsd"),
        ("fully-masked rows D128", "bfloat16", 1, 2, 1, 256, 128, 128, True,
         16, "bhsd"),
        ("fully-masked rows D256", "bfloat16", 1, 2, 1, 256, 128, 256, True,
         16, "bhsd"),
        ("Sq != Sk, ragged D128", "bfloat16", 1, 4, 2, 320, 200, 128, True,
         None, "bhsd"),
        ("non-causal D256", "bfloat16", 1, 4, 1, 200, 333, 256, False, None,
         "bshd"),
        ("D256 window 128 bf16", "bfloat16", 1, 4, 1, 640, 640, 256, True,
         128, "bshd"),
    ]


def ssd_cases():
    """(name, dtype, b, s, h, p, n, chunk); B and C are contiguous, except
    in the "column views" case, where they are column slices of one wider
    tensor, as the model passes them."""
    return [
        ("main fp32", "float32", 4, 512, 32, 64, 128, 256),
        ("main bf16", "bfloat16", 4, 512, 32, 64, 128, 256),
        ("3 chunks, small p n", "float32", 1, 192, 2, 32, 64, 64),
        ("b 3, h 5", "float32", 3, 256, 5, 64, 128, 128),
        ("p 128, chunk 96", "bfloat16", 2, 192, 3, 128, 96, 96),
        ("s 1024, 4 chunks", "float32", 2, 1024, 8, 64, 128, 256),
        ("one chunk of 2048", "float32", 1, 2048, 4, 64, 128, 2048),
        ("h 5 bf16", "bfloat16", 2, 256, 5, 64, 128, 128),
        ("B, C column views", "float32", 2, 512, 32, 64, 128, 256),
    ]


def rglru_cases():
    """(name, dtype, b, s, w, lam); lam None draws lam ~ N(0, 0.5)."""
    return [
        ("main fp32", "float32", 4, 512, 4096, None),
        ("main bf16", "bfloat16", 4, 512, 4096, None),
        ("ragged w", "float32", 2, 300, 1000, None),
        # softplus(-9) ~ 1.2e-4, so a ~ 0.999: the carry runs the whole way
        ("long s, a near 1", "float32", 1, 2048, 256, -9.0),
        # odd w: the bf16 kernel loads its two channels one by one
        ("odd w, short s", "bfloat16", 3, 37, 1001, None),
        ("ragged w, s 300", "bfloat16", 2, 300, 1000, None),
        ("s 1", "float32", 2, 1, 4096, None),
        ("s 1", "bfloat16", 2, 1, 4096, None),
        # 700 = 2 x 256 + 188: a ragged last super-chunk of the fp32 kernel
        ("s 700", "float32", 2, 700, 512, None),
        # softplus(-20) ~ 2e-9: a and exp(2 log_a) round to 1.0 where r is
        # below ~0.9, so 1 - exp(2 log_a) = 0 and the 1e-12 clamp bites
        ("lam -20, a = 1", "float32", 2, 512, 256, -20.0),
    ]


def make_inputs(gen, dtype, b, h, kh, sq, sk, d, layout):
    """q, k, v on the card; ``"bshd"`` gives the transposed views the model
    hands the kernel, ``"bhsd"`` contiguous tensors."""
    import torch

    def one(n, s):
        shape = (b, s, n, d) if layout == "bshd" else (b, n, s, d)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return x.transpose(1, 2) if layout == "bshd" else x
    return one(h, sq), one(kh, sk), one(kh, sk)


def phase_attention(torch, fa, ref, gen):
    worst, timing = 0.0, {}
    for (name, dt, b, h, kh, sq, sk, d, causal, window,
         layout) in attention_cases():
        dtype = getattr(torch, dt)
        q, k, v = make_inputs(gen, dtype, b, h, kh, sq, sk, d, layout)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
        torch.cuda.synchronize()
        if out.shape != (b, h, sq, d) or out.dtype != dtype:
            fail(f"flash {name}: output {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            fail(f"flash {name}: non-finite output")
        err = (out.float() - want).abs().max().item()
        if name.startswith("fully-masked rows"):
            # rows 143.. see no key: the mean of v over all keys
            mean_err = (out[0, :, 255].float()
                        - v[0, 0].float().mean(0)).abs().max().item()
            err = max(err, mean_err)
        ok = err <= TOL[dt]
        print(f"  flash {name:20s} {dt:8s} B={b} H={h} K={kh} Sq={sq} "
              f"Sk={sk} D={d} causal={causal} window={window} {layout}: "
              f"max|err| {err:.3e} (tol {TOL[dt]:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash {name}: max |err| {err} > {TOL[dt]}")
        worst = max(worst, err)
        if name.startswith("main"):
            sdpa = torch.nn.functional.scaled_dot_product_attention
            call = lambda: fa.flash_attention(q, k, v,  # noqa: E731
                                              causal=causal, window=window)
            ms, host_ms = time_ms(call), eager_ms(call)
            plain_ms = time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window))
            # the window (2048) never bites at S = 512, so is_causal is the
            # same function
            lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                          enable_gqa=True))
            bnd, by = attention_bound_ms(q, k, causal, window)
            timing[(d, dt)] = dict(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bnd,
                                   bound_by=by, sdpa_ratio=ms / lib_ms,
                                   max_abs_err=err, eager_ms=host_ms)
            print(f"    time: kernel {ms:.4f} ms (issued from Python one by "
                  f"one {host_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms (kernel / sdpa {ms / lib_ms:.2f}), "
                  f"bound {bnd:.4f} ms ({by}); kernel at {bnd / ms:.1%} of "
                  f"the bound")
    return worst, timing


def _close(out, want, atol, rtol):
    """max |out - want| and whether every element is within
    atol + rtol |want|."""
    diff = (out.float() - want).abs()
    return diff.max().item(), bool((diff <= atol + rtol * want.abs()).all())


def phase_ssd(torch, sk, ref, gen):
    F = torch.nn.functional
    worst, timing = 0.0, {}
    for name, dt, b, s, h, p, n, chunk in ssd_cases():
        dtype = getattr(torch, dt)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = (rnd(b, s, h, p) * 0.5).to(dtype)
        dts = F.softplus(rnd(b, s, h))
        A = -torch.exp(rnd(h) * 0.3)
        if name == "B, C column views":
            BC = (rnd(b, s, 2 * n + 16) * 0.3).to(dtype)
            B, C = BC[..., 16:16 + n], BC[..., 16 + n:]
            if sk.prepare(x, dts, A, B, C)[2].data_ptr() != B.data_ptr():
                fail(f"ssd {name}: prepare() copied the column views")
        else:
            B = (rnd(b, s, n) * 0.3).to(dtype)
            C = (rnd(b, s, n) * 0.3).to(dtype)
        y, st = sk.ssd_scan(x, dts, A, B, C, chunk=chunk)
        yr, sr = ref.ssd_scan_ref(x.float(), dts, A, B.float(), C.float(),
                                  chunk)
        torch.cuda.synchronize()
        if y.shape != x.shape or y.dtype != dtype or st.shape != (
                b, h, p, n) or st.dtype != torch.float32:
            fail(f"ssd {name}: outputs {tuple(y.shape)} {y.dtype}, "
                 f"{tuple(st.shape)} {st.dtype}")
        if not (bool(torch.isfinite(y).all()) and bool(
                torch.isfinite(st).all())):
            fail(f"ssd {name}: non-finite output")
        atol, rtol = SSD_TOL[dt]
        ey, oky = _close(y, yr, atol, rtol)
        es_, oks = _close(st, sr, atol, rtol)
        print(f"  ssd {name:20s} {dt:8s} b={b} s={s} h={h} p={p} n={n} "
              f"chunk={chunk}: max|err| y {ey:.3e}, state {es_:.3e} "
              f"(atol {atol:.0e}, rtol {rtol:.0e}) "
              f"{'ok' if oky and oks else 'FAIL'}")
        if not (oky and oks):
            fail(f"ssd {name}: y err {ey}, state err {es_}")
        worst = max(worst, ey, es_)
        if name.startswith("main"):
            prep = sk.prepare(x, dts, A, B, C)
            call = lambda: sk.ssd_scan(x, dts, A, B, C,  # noqa: E731
                                       chunk=chunk)
            ms, host_ms = time_ms(call), eager_ms(call)
            kms = time_ms(lambda: sk.launch(*prep, chunk=chunk))
            plain_ms = time_ms(lambda: ref.ssd_scan_ref(x, dts, A, B, C,
                                                        chunk), iters=5)
            es = x.element_size()
            bnd, by = ssd_bound_ms(b, s, h, p, n, chunk, dt, es)
            kbnd, kby = ssd_bound_ms(b, s, h, p, n, chunk, dt, es, True)
            timing[dt] = dict(ms=ms, kernel_ms=kms, plain_ms=plain_ms,
                              library_ms=None, bound_ms=bnd, bound_by=by,
                              kernel_bound_ms=kbnd, max_abs_err=max(ey, es_),
                              eager_ms=host_ms)
            print(f"    time: wrapper {ms:.4f} ms (kernel alone {kms:.4f} "
                  f"ms; wrapper issued from Python one by one {host_ms:.4f} "
                  f"ms), plain {plain_ms:.4f} ms, no library call; bound "
                  f"{bnd:.4f} ms ({by}), kernel alone {kbnd:.4f} ms ({kby});"
                  f" wrapper at {bnd / ms:.1%} of the bound")
    return worst, timing


def cuda_kernels_per_call(torch, fn, calls=3) -> float:
    """CUDA kernels that ``torch.profiler`` sees run, per call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls


def phase_rglru(torch, rk, ref, gen):
    worst, timing = 0.0, {}
    for name, dt, b, s, w, lam_v in rglru_cases():
        dtype = getattr(torch, dt)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = (rnd(b, s, w) * 0.5).to(dtype)
        r = torch.sigmoid(rnd(b, s, w)).to(dtype)
        i = torch.sigmoid(rnd(b, s, w)).to(dtype)
        lam = rnd(w) * 0.5 if lam_v is None else torch.full(
            (w,), lam_v, device="cuda")
        before = rk.launches
        y = rk.rglru_scan(x, r, i, lam)
        counted = rk.launches - before
        yr = ref.rglru_ref(x.float(), r.float(), i.float(), lam)
        torch.cuda.synchronize()
        if y.shape != x.shape or y.dtype != dtype or counted != 1:
            fail(f"rglru {name}: output {tuple(y.shape)} {y.dtype}, "
                 f"{counted} launches counted")
        if not bool(torch.isfinite(y).all()):
            fail(f"rglru {name}: non-finite output")
        atol, rtol = RGLRU_TOL[dt]
        err, ok = _close(y, yr, atol, rtol)
        extra = ""
        if dtype == torch.bfloat16:
            # the plain version on the same bf16 inputs rounds i x to bf16
            yb = ref.rglru_ref(x, r, i, lam)
            errb, okb = _close(y, yb.float(), atol, rtol)
            share = (y != yb).float().mean().item()
            ok = ok and okb and share <= RGLRU_BF16_MISMATCH
            extra = (f"; vs plain on bf16 inputs {errb:.3e}, {share:.4%} of "
                     f"outputs differ (at most {RGLRU_BF16_MISMATCH:.0%})")
            err = max(err, errb)
        print(f"  rglru {name:18s} {dt:8s} b={b} s={s} w={w} lam="
              f"{'N(0,0.5)' if lam_v is None else lam_v}: max|err| "
              f"{err:.3e} (atol {atol:.0e}, rtol {rtol:.0e}){extra} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"rglru {name}: max |err| {err}{extra}")
        worst = max(worst, err)
        if name.startswith("main"):
            call = lambda: rk.rglru_scan(x, r, i, lam)  # noqa: E731
            per_call = cuda_kernels_per_call(torch, call)
            if per_call != 1:
                fail(f"rglru {name}: {per_call} CUDA kernels a call, not 1")
            ms, host_ms = time_ms(call), eager_ms(call)
            plain_ms = time_ms(lambda: ref.rglru_ref(x, r, i, lam), iters=5)
            bnd, by = rglru_bound_ms(b, s, w, dt, x.element_size())
            timing[dt] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                              bound_ms=bnd, bound_by=by, max_abs_err=err,
                              eager_ms=host_ms)
            print(f"    time: wrapper {ms:.4f} ms, one CUDA kernel a call "
                  f"(issued from Python one by one {host_ms:.4f} ms), plain "
                  f"{plain_ms:.4f} ms, no library call; bound {bnd:.4f} ms "
                  f"({by}); wrapper at {bnd / ms:.1%} of the bound")
    return worst, timing


def expected_prefill_launches(cfg) -> dict[str, int]:
    """One launch per layer that holds the kernel."""
    from repro_torch.models.model import griffin_pattern, layer_groups
    want = {"flash": 0, "ssd": 0, "rglru": 0}
    for kind, count in layer_groups(cfg):
        if kind == "dense":
            want["flash"] += count
        elif kind == "mamba":
            want["ssd"] += count
        else:
            for sub in griffin_pattern(cfg, kind):
                want["rglru" if sub == "rec" else "flash"] += count
    return want


def phase_serve(torch, policy, arch):
    print(f"== phase 4: serve {arch} full width, full depth")
    import numpy as np

    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.models.model import _leaves, init_params
    from repro_torch.train.steps import build_prefill_step

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params fp32 ({weights / 1e9:.2f} GB), "
          f"init {time.perf_counter() - t0:.1f} s, init peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (BATCH, PROMPT))).to("cuda")

    policy.set_policy("auto")
    # a warm-up prefill: the timed one then excludes cuBLAS's first-call setup
    build_prefill_step(cfg)(params, {"tokens": prompts})
    for mod in serve.KERNELS.values():
        mod.launches = 0
    res = serve.generate(params, cfg, prompts, GEN)
    launches = serve.launch_counts()

    print(f"  prefill {BATCH}x{PROMPT}: {res['prefill_ms']:.2f} ms; cache "
          f"fill ({PROMPT} decode steps) {res['fill_ms']:.1f} ms; decode "
          f"{GEN - 1} steps {res['decode_ms']:.1f} ms = "
          f"{res['decode_tok_s']:.1f} tok/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = expected_prefill_launches(cfg)
    print(f"  kernel launches: prefill {res['prefill_launches']}, whole run "
          f"{launches} (expected {want} in prefill, none in decode)")
    print(f"  prefill vs teacher-forced logits: max |diff| "
          f"{res['max_abs_diff']:.3e} (atol 2e-3, rtol 1e-3, same argmax): "
          f"{'ok' if res['agree'] else 'FAIL'}")
    print("  sample (token ids):", res["tokens"][0, :16].tolist())
    if res["prefill_launches"] != want or launches != want:
        fail(f"{arch}: expected {want} launches in prefill and none in "
             f"decode; prefill {res['prefill_launches']}, whole run "
             f"{launches}")
    if not res["agree"]:
        fail(f"{arch}: prefill and teacher-forced decode logits disagree")
    for key in ("prefill_logits", "teacher_logits"):
        if res[key].shape != (BATCH, cfg.vocab) or not bool(
                torch.isfinite(res[key]).all()):
            fail(f"{arch} {key}: shape {tuple(res[key].shape)} or "
                 f"non-finite")
    if tuple(res["tokens"].shape) != (BATCH, GEN):
        fail(f"{arch}: tokens shape {tuple(res['tokens'].shape)}")

    # the same prefill through the plain versions on the card
    policy.set_policy("ref")
    try:
        plain = build_prefill_step(cfg)(params, {"tokens": prompts})
    finally:
        policy.set_policy("auto")
    diff = (plain - res["prefill_logits"]).abs().max().item()
    same = bool(torch.allclose(plain, res["prefill_logits"], atol=2e-3,
                               rtol=1e-3)) and bool(
        (plain.argmax(-1) == res["prefill_logits"].argmax(-1)).all())
    print(f"  prefill, kernels vs plain versions: max |diff| {diff:.3e}: "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        fail(f"{arch}: prefill through the kernels disagrees with the "
             f"plain path")
    where_the_time_goes(torch, cfg, params, prompts)
    del params, res, plain
    torch.cuda.empty_cache()
    return launches


def where_the_time_goes(torch, cfg, params, prompts, steps=8):
    """Host time of one prefill and of ``steps`` decode steps, their summed
    device kernel time under ``torch.profiler`` (so the device's busy
    share), and the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import init_decode_state
    from repro_torch.train.steps import build_decode_step, build_prefill_step

    prefill, step = build_prefill_step(cfg), build_decode_step(cfg)
    state = init_decode_state(cfg, BATCH, PROMPT + GEN, device="cuda")
    tok = prompts[:, :1]

    def run_prefill():
        prefill(params, {"tokens": prompts})

    def run_decode():
        for _ in range(steps):
            step(params, state, {"tokens": tok})

    print(f"== where the time goes, {cfg.name} (host clock; device time "
          f"from torch.profiler)")
    for name, fn, n in (("prefill", run_prefill, 1),
                        ("decode step", run_decode, steps)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        dev_ms = [(getattr(e, "self_device_time_total", None)
                   or e.self_cuda_time_total) / 1e3 / n for e in kernels]
        busy = sum(dev_ms)
        top = sorted(zip(dev_ms, (e.key for e in kernels)), reverse=True)[:6]
        print(f"  {name}: host {wall:.3f} ms, device kernels {busy:.3f} ms "
              f"({busy / wall:.1%} busy), {sum(e.count for e in kernels) // n}"
              f" kernel launches")
        for ms, key in top:
            print(f"    {ms:8.3f} ms  {key[:90]}")


def block_weights(prog, rng):
    """Norm weights at one, the rest N(0, 0.05^2), drawn in parameter
    order as ``tests/test_archs.py`` draws them."""
    import numpy as np
    return {t.name: np.ones(t.shape, np.float32)
            if "norm" in t.name.split("/")[-1]
            else (rng.standard_normal(t.shape) * 0.05).astype(np.float32)
            for t in prog.graph.parameters()}


def block_feeds(cfg, rng, batch, seq):
    import numpy as np
    return {"ids": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (batch, seq))
            .astype(np.int32)}


def check_against_simulator(what, got, want_loss, want_grads):
    """Step 1's loss and every gradient against the simulator's: the
    elementwise tolerance of ``tests/test_archs.py`` and, since at full
    vocabulary the gradients are far below its atol, the normwise
    relative error ||got - want|| / ||want|| <= GRAD_NORM_RTOL as well,
    except for the key biases: their gradient is mathematically zero
    (softmax is shift-invariant along the keys), so both sides are
    rounding noise and only the elementwise tolerance applies."""
    import numpy as np
    lerr = abs(got.loss - want_loss) / abs(want_loss)
    worst, worst_name, bad = 0.0, None, []
    for name, want in want_grads.items():
        g = got.grad_value(name)
        if g.shape != want.shape or not np.isfinite(g).all():
            fail(f"{what}: grad {name} shape {g.shape} or non-finite")
        if not np.allclose(g, want, atol=GRAD_ATOL, rtol=GRAD_RTOL):
            bad.append(name)
        if name.endswith("/bk"):
            continue
        norm = float(np.linalg.norm(want.astype(np.float64)))
        rel = float(np.linalg.norm((g - want).astype(np.float64))) / norm \
            if norm else float(np.abs(g).max())
        if rel > worst:
            worst, worst_name = rel, name
    ok = lerr <= LOSS_RTOL and not bad and worst <= GRAD_NORM_RTOL
    print(f"  {what} vs SimulatorExecutor: loss {got.loss:.9e} vs "
          f"{want_loss:.9e} (rel {lerr:.2e}, rtol {LOSS_RTOL:.0e}); "
          f"{len(want_grads)} grads within atol {GRAD_ATOL:.0e} rtol "
          f"{GRAD_RTOL:.0e}: {'all' if not bad else bad}; worst normwise "
          f"relative error {worst:.2e} ({worst_name}; limit "
          f"{GRAD_NORM_RTOL:.0e}): {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what}: step 1 disagrees with the simulator")


def device_breakdown(prof):
    """Device time of the profiled window by kind: the flash kernel, the
    GEMMs, host<->device copies and the rest (elementwise, gathers,
    reductions); in ms, with the launch count and the six heaviest."""
    from torch.autograd import DeviceType
    parts = {"flash (B1)": 0.0, "GEMM": 0.0, "copy host<->device": 0.0,
             "other kernels": 0.0}
    launches, top = 0, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = (getattr(e, "self_device_time_total", None)
              or e.self_cuda_time_total) / 1e3
        key = e.key.lower()
        launches += e.count
        top.append((ms, e.key))
        if "flash_" in key:
            parts["flash (B1)"] += ms
        elif "gemm" in key or "cutlass" in key:
            parts["GEMM"] += ms
        elif "memcpy" in key and ("htod" in key or "dtoh" in key):
            parts["copy host<->device"] += ms
        else:
            parts["other kernels"] += ms
    return parts, launches, sorted(top, reverse=True)[:6]


def phase_graph_ir(torch, fa, ref):
    """Graph-IR training on ``TorchExecutor``: full-width Qwen2-1.5B
    blocks under dp2 x tp2, then reduced Llama under tp2 x pp2 with two
    microbatches.  Returns B1's launches on this path and its timings at
    the path's shape."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models.graph_block import block_program

    cfg = get_config("qwen2-1.5b")
    print(f"== phase 5: graph-IR training, {cfg.name} full width "
          f"(d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), {IR_LAYERS} "
          f"layers, batch {IR_BATCH}, seq {IR_SEQ}, dp2 x tp2 on 4 virtual "
          f"devices stacked on the one GPU")
    prog = block_program(cfg, batch=IR_BATCH, seq=IR_SEQ, n_layers=IR_LAYERS,
                         dp=2, tp=2, pp=1)
    rng = np.random.default_rng(0)
    feeds = block_feeds(cfg, rng, IR_BATCH, IR_SEQ)
    ws = block_weights(prog, rng)
    print(f"  {sum(w.size for w in ws.values()) / 1e6:.1f} M parameters, "
          f"random from seed 0 (numpy)")

    # the reference: the port's SimulatorExecutor, in numpy on the host
    t0 = time.perf_counter()
    sim = api.Session(prog, 0, executor=api.SimulatorExecutor())
    sim.load(ws)
    want = sim.train_step(dict(feeds))
    want_loss = want.loss
    want_grads = {n: want.grad_value(n) for n in ws}
    print(f"  SimulatorExecutor step 1 on the host: "
          f"{time.perf_counter() - t0:.1f} s, loss {want_loss:.9e}")
    del sim, want

    ex = api.TorchExecutor()
    sess = api.Session(prog, 0, executor=ex)
    sess.load(ws)
    tplan = prog.compile_train(0)
    fetch = [tplan.loss_name] + [tplan.grad_map[t.name]
                                 for t in tplan.graph.parameters()]
    stats = ex.lowered(tplan, fetch).stats
    classes = stats.kernel_dispatches
    print(f"  lowered: {stats.compute_segments} segments "
          f"({stats.straightline_segments} one class over every row), "
          f"{stats.stages} comm stages ({stats.uniform_reduce_stages} "
          f"whole-buffer reduces, {stats.uniform_copy_stages} whole-buffer "
          f"copies), attention classes: {classes} on B1, "
          f"{stats.ref_dispatches} on the plain version")
    if classes != IR_LAYERS or stats.ref_dispatches:
        fail(f"graph IR: expected {IR_LAYERS} attention classes on B1 "
             f"(one per layer), got {classes} and {stats.ref_dispatches} "
             f"plain")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, per_step, opt_s = [], [], [], []
    fa.launches = 0
    try:
        for step in range(3):
            before = fa.launches
            ex.times.reset()
            profiled = step == 2
            ex.times.sync = profiled
            t0 = time.perf_counter()
            if profiled:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    r = sess.train_step(dict(feeds))
                    torch.cuda.synchronize()
            else:
                r = sess.train_step(dict(feeds))
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_step.append(fa.launches - before)
            opt_s.append(r.update_seconds)
            losses.append(r.loss)
            if step == 0:
                check_against_simulator("Qwen2-1.5B dp2 x tp2 step 1", r,
                                        want_loss, want_grads)
            parts = ex.times.as_dict()
            print(f"  step {step + 1}: loss {r.loss:.9e}, "
                  f"{walls[-1] * 1e3:.1f} ms{' (profiled)' if profiled else ''}"
                  f", grad norm {r.metrics['grad_norm']:.3e}, B1 launches "
                  f"{per_step[-1]} (the lowered graph dispatches "
                  f"{classes})")
    finally:
        ex.times.sync = False
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(p != classes for p in per_step):
        fail(f"graph IR: B1 launches per step {per_step}, expected "
             f"{classes} (layers x classes)")
    if not all(np.isfinite(losses)) or len(set(losses)) != len(losses):
        fail(f"graph IR: losses {losses} not finite or not changing")
    other = walls[2] - sum(parts[p] for p in ("pack", "compute", "comm",
                                              "fetch")) - opt_s[2]
    print(f"  step time (host clock, synchronized): step 1 "
          f"{walls[0] * 1e3:.1f} ms, step 2 {walls[1] * 1e3:.1f} ms; peak "
          f"memory {peak:.2f} GiB")
    print(f"  where step 3's {walls[2] * 1e3:.1f} ms go (host clock, device "
          f"synchronized at each boundary): pack numpy shards + copy to the "
          f"device {parts['pack'] * 1e3:.1f} ms; compute segments "
          f"{parts['compute'] * 1e3:.1f} ms (of which B1 "
          f"{parts['attention'] * 1e3:.2f} ms); comm row moves "
          f"{parts['comm'] * 1e3:.1f} ms; copy fetches to the host + unpack "
          f"{parts['fetch'] * 1e3:.1f} ms; host numpy AdamW "
          f"{opt_s[2] * 1e3:.1f} ms; the rest of the session "
          f"{other * 1e3:.1f} ms")
    dev, n_launch, top = device_breakdown(prof)
    busy = sum(dev.values())
    print(f"  step 3 on the device (torch.profiler): {busy:.1f} ms of "
          f"{walls[2] * 1e3:.1f} ms host ({busy / (walls[2] * 1e3):.1%} "
          f"busy), {n_launch} device activities: " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in dev.items()))
    for ms_, key in top:
        print(f"    {ms_:9.3f} ms  {key[:90]}")
    print(f"  host numpy AdamW per step: "
          + ", ".join(f"{s * 1e3:.1f} ms" for s in opt_s))

    # B1 at this path's shape: the four device rows fold into the batch
    b, h, kh = IR_BATCH // 2 * 4, cfg.n_heads // 2, cfg.n_kv_heads // 2
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((b, h, IR_SEQ, cfg.hd), generator=gen, device="cuda")
    k = torch.randn((b, kh, IR_SEQ, cfg.hd), generator=gen, device="cuda")
    v = torch.randn((b, kh, IR_SEQ, cfg.hd), generator=gen, device="cuda")
    out = fa.flash_attention(q, k, v, causal=True)
    err = (out - ref.flash_attention_ref(q, k, v, causal=True)).abs().max() \
        .item()
    if err > TOL["float32"]:
        fail(f"flash at the graph-IR shape: max |err| {err}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True))
    lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    bnd, by = attention_bound_ms(q, k, True, None)
    shape = (f"B{b} H{h} K{kh} S{IR_SEQ} D{cfg.hd} causal fp32 (graph-IR "
             f"Qwen2-1.5B dp2 x tp2: 4 device rows folded into the batch)")
    print(f"  B1 at {shape}: max|err| {err:.3e}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bnd:.4f} ms "
          f"({by}); {IR_LAYERS} launches a step = "
          f"{IR_LAYERS * ms:.3f} ms of the step")
    timing = dict(shape=shape, launches=launches, ms=ms, plain_ms=plain_ms,
                  library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                  max_abs_err=err)
    del sess, ex, q, k, v, out
    torch.cuda.empty_cache()

    # the pipeline path: reduced Llama, tp2 x pp2, two microbatches, 1f1b
    lcfg = get_config("llama_32b").reduced()
    print(f"  {lcfg.name} reduced ({lcfg.n_layers} layers, d_model "
          f"{lcfg.d_model}, {lcfg.n_heads} heads of {lcfg.hd}), batch "
          f"{IR_BATCH}, seq {IR_SEQ}, tp2 x pp2, 2 microbatches, 1f1b")
    lprog = block_program(lcfg, batch=IR_BATCH, seq=IR_SEQ, dp=1, tp=2, pp=2)
    rng = np.random.default_rng(0)
    lfeeds = block_feeds(lcfg, rng, IR_BATCH, IR_SEQ)
    lws = block_weights(lprog, rng)
    sim = api.Session(lprog, 0, executor=api.SimulatorExecutor())
    sim.load(lws)
    want = sim.train_step(dict(lfeeds), num_microbatches=2)
    lex = api.TorchExecutor()
    lsess = api.Session(lprog, 0, executor=lex)
    lsess.load(lws)
    ltplan = lprog.compile_train(0, num_microbatches=2)
    lstats = lex.lowered(ltplan, [ltplan.loss_name] + [
        ltplan.grad_map[t.name] for t in ltplan.graph.parameters()], 2).stats
    before = fa.launches
    t0 = time.perf_counter()
    r = lsess.train_step(dict(lfeeds), num_microbatches=2, schedule="1f1b")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = fa.launches - before
    want_launches = lcfg.n_layers * 2
    print(f"  step: {wall * 1e3:.1f} ms, B1 launches {got} (the lowered "
          f"graph dispatches {lstats.kernel_dispatches} a microbatch; "
          f"expected {want_launches}: layers x one class x 2 microbatches)")
    if got != want_launches or \
            lstats.kernel_dispatches * 2 != want_launches or \
            lstats.ref_dispatches:
        fail(f"graph IR pipeline: B1 launches {got}, dispatches "
             f"{lstats.kernel_dispatches} on B1 and "
             f"{lstats.ref_dispatches} plain, expected {want_launches}")
    check_against_simulator("Llama reduced tp2 x pp2 m=2",
                            r, want.loss, {n: want.grad_value(n)
                                           for n in lws})
    timing["launches"] += got
    return timing


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import policy, ref
    from repro_torch.kernels import rglru_scan as rk
    from repro_torch.kernels import ssd_scan as sk

    print("== phase 1: device")
    card = card_line()
    print(card)
    resolve_device("cuda")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s); TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    print("== phase 2: build")
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    reports = _build.build(sources)
    for name in sources:
        _build.load(name)
    print(f"  built {sorted(reports)} of {sources} in "
          f"{time.perf_counter() - t0:.1f} s")
    spills = []
    for name, log in reports.items():
        for fn, regs, st, ld in ptxas_report(log):
            print(f"  {name}: {fn}: {regs} registers, spill stores {st} B, "
                  f"loads {ld} B")
            if st or ld:
                spills.append(f"{name}: {fn}")
    print(f"  ptxas spills: {spills or 'none'}")
    if any(s.startswith("rglru_scan:") for s in spills):
        fail("the RG-LRU kernel spills registers")

    print("== phase 3: kernels vs plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fa_worst, fa_t = phase_attention(torch, fa, ref, gen)
    ssd_worst, ssd_t = phase_ssd(torch, sk, ref, gen)
    rg_worst, rg_t = phase_rglru(torch, rk, ref, gen)

    paths = {arch: phase_serve(torch, policy, arch) for arch in ARCHS}
    total = {k: sum(p[k] for p in paths.values()) for k in paths[ARCHS[0]]}
    ir = phase_graph_ir(torch, fa, ref)
    total["flash"] += ir["launches"]

    def entry(name, source, replaces, launches, worst, t, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": worst, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                **extra}

    csrc = "src/repro_torch/csrc/"
    flash_shapes = [
        {"shape": "B4 H12 K2 S512 D128 causal fp32 (Qwen2-1.5B prefill)",
         "launches": paths["qwen2-1.5b"]["flash"], **fa_t[(128, "float32")]},
        {"shape": "B4 H16 K1 S512 D256 causal window 2048 fp32 "
                  "(RecurrentGemma-9B prefill)",
         "launches": paths["recurrentgemma-9b"]["flash"],
         **fa_t[(256, "float32")]},
        ir,
        {"shape": "B4 H12 K2 S512 D128 causal bf16 (tensor cores)",
         "launches": 0, **fa_t[(128, "bfloat16")]},
        {"shape": "B4 H16 K1 S512 D256 causal window 2048 bf16 (tensor "
                  "cores)", "launches": 0, **fa_t[(256, "bfloat16")]}]
    kernels = [
        entry("flash_attention", csrc + "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:114", total["flash"],
              fa_worst, fa_t[(128, "float32")], cuda_launches_per_call=1,
              shapes=flash_shapes),
        entry("ssd_scan", csrc + "ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:92", total["ssd"], ssd_worst,
              ssd_t["float32"], kernel_ms=ssd_t["float32"]["kernel_ms"],
              cuda_launches_per_call=3,
              shape="b4 s512 h32 p64 n128 chunk256 fp32 "
                    "(Mamba2-370M prefill)", bf16=ssd_t["bfloat16"]),
        entry("rglru_scan", csrc + "rglru_scan.cu",
              "src/repro/kernels/rglru_scan.py:70", total["rglru"], rg_worst,
              rg_t["float32"], cuda_launches_per_call=1,
              shape="b4 s512 w4096 fp32 (RecurrentGemma-9B prefill)",
              bf16=rg_t["bfloat16"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
