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
   the RG-LRU scan.  At the main shapes it times the kernel's wrapper, the
   kernel alone where the wrapper prepares its inputs, the plain version,
   the bound, and one library call where one computes the same function
   (``scaled_dot_product_attention``, a yardstick the port never calls).
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
5. the kernels line, then the card line, then the result line.

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
ARCHS = ("qwen2-1.5b", "mamba2-370m", "recurrentgemma-9b")
BATCH, PROMPT, GEN = 4, 512, 32


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters=20, warmup=3) -> float:
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


def rglru_bound_ms(b, s, w, dtype, es, kernel_only=False):
    """Bytes: the function reads x, r, i (in ``dtype``) and lam and writes
    y; the kernel alone reads the fp32 a and b terms and writes y.  Its
    flops (a dozen elementwise ones per element) weigh nothing beside."""
    nbytes = (8 + es) * b * s * w if kernel_only \
        else es * 4 * b * s * w + 4 * w
    return bound(12.0 * b * s * w, nbytes, dtype)


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
    ]


def ssd_cases():
    """(name, dtype, b, s, h, p, n, chunk)."""
    return [
        ("main fp32", "float32", 4, 512, 32, 64, 128, 256),
        ("main bf16", "bfloat16", 4, 512, 32, 64, 128, 256),
        ("3 chunks, small p n", "float32", 1, 192, 2, 32, 64, 64),
        ("b 3, h 5", "float32", 3, 256, 5, 64, 128, 128),
        ("p 128, chunk 96", "bfloat16", 2, 192, 3, 128, 96, 96),
    ]


def rglru_cases():
    """(name, dtype, b, s, w, lam); lam None draws lam ~ N(0, 0.5)."""
    return [
        ("main fp32", "float32", 4, 512, 4096, None),
        ("main bf16", "bfloat16", 4, 512, 4096, None),
        ("ragged w", "float32", 2, 300, 1000, None),
        # softplus(-9) ~ 1.2e-4, so a ~ 0.999: the carry runs the whole way
        ("long s, a near 1", "float32", 1, 2048, 256, -9.0),
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
        if name == "fully-masked rows":
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
            ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                    window=window))
            plain_ms = time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window))
            # the window (2048) never bites at S = 512, so is_causal is the
            # same function
            lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                          enable_gqa=True))
            bnd, by = attention_bound_ms(q, k, causal, window)
            timing[(d, dt)] = dict(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bnd,
                                   bound_by=by)
            print(f"    time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}); "
                  f"kernel at {bnd / ms:.1%} of the bound")
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
            ms = time_ms(lambda: sk.ssd_scan(x, dts, A, B, C, chunk=chunk))
            kms = time_ms(lambda: sk.launch(*prep, chunk=chunk))
            plain_ms = time_ms(lambda: ref.ssd_scan_ref(x, dts, A, B, C,
                                                        chunk), iters=5)
            es = x.element_size()
            bnd, by = ssd_bound_ms(b, s, h, p, n, chunk, dt, es)
            kbnd, kby = ssd_bound_ms(b, s, h, p, n, chunk, dt, es, True)
            timing[dt] = dict(ms=ms, kernel_ms=kms, plain_ms=plain_ms,
                              library_ms=None, bound_ms=bnd, bound_by=by,
                              kernel_bound_ms=kbnd)
            print(f"    time: wrapper {ms:.4f} ms (kernel alone {kms:.4f} "
                  f"ms), plain {plain_ms:.4f} ms, no library call; bound "
                  f"{bnd:.4f} ms ({by}), kernel alone {kbnd:.4f} ms ({kby});"
                  f" wrapper at {bnd / ms:.1%} of the bound")
    return worst, timing


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
        y = rk.rglru_scan(x, r, i, lam)
        yr = ref.rglru_ref(x.float(), r.float(), i.float(), lam)
        torch.cuda.synchronize()
        if y.shape != x.shape or y.dtype != dtype:
            fail(f"rglru {name}: output {tuple(y.shape)} {y.dtype}")
        if not bool(torch.isfinite(y).all()):
            fail(f"rglru {name}: non-finite output")
        atol, rtol = RGLRU_TOL[dt]
        err, ok = _close(y, yr, atol, rtol)
        print(f"  rglru {name:18s} {dt:8s} b={b} s={s} w={w} lam="
              f"{'N(0,0.5)' if lam_v is None else lam_v}: max|err| "
              f"{err:.3e} (atol {atol:.0e}, rtol {rtol:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"rglru {name}: max |err| {err}")
        worst = max(worst, err)
        if name.startswith("main"):
            coef = ref.rglru_coefficients(x, r, i, lam)
            ms = time_ms(lambda: rk.rglru_scan(x, r, i, lam))
            kms = time_ms(lambda: rk.launch(*coef, dtype))
            plain_ms = time_ms(lambda: ref.rglru_ref(x, r, i, lam), iters=5)
            es = x.element_size()
            bnd, by = rglru_bound_ms(b, s, w, dt, es)
            kbnd, kby = rglru_bound_ms(b, s, w, dt, es, True)
            timing[dt] = dict(ms=ms, kernel_ms=kms, plain_ms=plain_ms,
                              library_ms=None, bound_ms=bnd, bound_by=by,
                              kernel_bound_ms=kbnd)
            print(f"    time: wrapper {ms:.4f} ms (kernel alone {kms:.4f} "
                  f"ms), plain {plain_ms:.4f} ms, no library call; bound "
                  f"{bnd:.4f} ms ({by}), kernel alone {kbnd:.4f} ms ({kby});"
                  f" wrapper at {bnd / ms:.1%} of the bound")
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
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("== phase 3: kernels vs plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fa_worst, fa_t = phase_attention(torch, fa, ref, gen)
    ssd_worst, ssd_t = phase_ssd(torch, sk, ref, gen)
    rg_worst, rg_t = phase_rglru(torch, rk, ref, gen)

    paths = {arch: phase_serve(torch, policy, arch) for arch in ARCHS}
    total = {k: sum(p[k] for p in paths.values()) for k in paths[ARCHS[0]]}

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
         **fa_t[(256, "float32")]}]
    kernels = [
        entry("flash_attention", csrc + "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:114", total["flash"],
              fa_worst, fa_t[(128, "float32")], shapes=flash_shapes),
        entry("ssd_scan", csrc + "ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:92", total["ssd"], ssd_worst,
              ssd_t["float32"], kernel_ms=ssd_t["float32"]["kernel_ms"],
              shape="b4 s512 h32 p64 n128 chunk256 fp32 "
                    "(Mamba2-370M prefill)"),
        entry("rglru_scan", csrc + "rglru_scan.cu",
              "src/repro/kernels/rglru_scan.py:70", total["rglru"], rg_worst,
              rg_t["float32"], kernel_ms=rg_t["float32"]["kernel_ms"],
              shape="b4 s512 w4096 fp32 (RecurrentGemma-9B prefill)"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
