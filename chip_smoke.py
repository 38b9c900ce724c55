#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions; TF32 off.
2. build: every kernel of the port from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all at once.
3. kernel vs plain: flash attention against its plain PyTorch version on
   the card, at the main path's prefill shape and at the edge cases, with
   timings of the kernel, the plain version and one library call
   (``scaled_dot_product_attention``, a yardstick the port never calls).
4. serve: full-width Qwen2-1.5B (28 layers, fp32, random weights from seed
   0) answers 4 prompts of 512 tokens and generates 32 tokens each.  The
   kernel counts are set to 0 just before and read just after; prefill
   must launch flash attention once per layer, the teacher-forced decode
   logits must agree with prefill's, and prefill must agree with the plain
   attention path on the card.
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
ARCH, BATCH, PROMPT, GEN = "qwen2-1.5b", 4, 512, 32


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
    rate = PEAK_FLOPS[str(q.dtype).removeprefix("torch.")]
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_cases():
    """(name, dtype, B, H, K, Sq, Sk, D, causal, window, layout)."""
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


def phase_kernels(torch, fa, ref):
    print("== phase 3: flash attention vs plain version on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, timing = 0.0, {}
    for (name, dt, b, h, kh, sq, sk, d, causal, window,
         layout) in kernel_cases():
        dtype = getattr(torch, dt)
        q, k, v = make_inputs(gen, dtype, b, h, kh, sq, sk, d, layout)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
        torch.cuda.synchronize()
        if out.shape != (b, h, sq, d) or out.dtype != dtype:
            fail(f"{name}: output {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            fail(f"{name}: non-finite output")
        err = (out.float() - want).abs().max().item()
        if name == "fully-masked rows":
            # rows 143.. see no key: the mean of v over all keys
            mean_err = (out[0, :, 255].float()
                        - v[0, 0].float().mean(0)).abs().max().item()
            err = max(err, mean_err)
        ok = err <= TOL[dt]
        print(f"  {name:22s} {dt:8s} B={b} H={h} K={kh} Sq={sq} Sk={sk} "
              f"D={d} causal={causal} window={window} {layout}: "
              f"max|err| {err:.3e} (tol {TOL[dt]:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name}: max |err| {err} > {TOL[dt]}")
        worst = max(worst, err)
        if name.startswith("main"):
            sdpa = torch.nn.functional.scaled_dot_product_attention
            ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
            plain_ms = time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True))
            lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                          enable_gqa=True))
            bound, by = attention_bound_ms(q, k, causal, window)
            timing[dt] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound, bound_by=by)
            print(f"    time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
                  f"kernel at {bound / ms:.1%} of the bound")
    return worst, timing


def phase_serve(torch, fa, policy):
    print(f"== phase 4: serve {ARCH} full width")
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import generate
    from repro_torch.train.steps import build_prefill_step

    cfg = get_config(ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params fp32, init "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (BATCH, PROMPT))).to("cuda")

    policy.set_policy("auto")
    # a warm-up prefill: the timed one then excludes cuBLAS's first-call setup
    build_prefill_step(cfg)(params, {"tokens": prompts})
    fa.launches = 0
    res = generate(params, cfg, prompts, GEN)
    launches = fa.launches

    print(f"  prefill {BATCH}x{PROMPT}: {res['prefill_ms']:.2f} ms; cache "
          f"fill ({PROMPT} decode steps) {res['fill_ms']:.1f} ms; decode "
          f"{GEN - 1} steps {res['decode_ms']:.1f} ms = "
          f"{res['decode_tok_s']:.1f} tok/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  flash-attention launches: prefill {res['prefill_launches']}, "
          f"whole run {launches}")
    print(f"  prefill vs teacher-forced logits: max |diff| "
          f"{res['max_abs_diff']:.3e} (atol 2e-3, rtol 1e-3, same argmax): "
          f"{'ok' if res['agree'] else 'FAIL'}")
    print("  sample (token ids):", res["tokens"][0, :16].tolist())
    if res["prefill_launches"] != cfg.n_layers or launches != cfg.n_layers:
        fail(f"expected {cfg.n_layers} flash-attention launches, prefill "
             f"{res['prefill_launches']}, whole run {launches}")
    if not res["agree"]:
        fail("prefill and teacher-forced decode logits disagree")
    for key in ("prefill_logits", "teacher_logits"):
        if res[key].shape != (BATCH, cfg.vocab) or not bool(
                torch.isfinite(res[key]).all()):
            fail(f"{key}: shape {tuple(res[key].shape)} or non-finite")
    if tuple(res["tokens"].shape) != (BATCH, GEN):
        fail(f"tokens shape {tuple(res['tokens'].shape)}")

    # the same prefill through the plain attention path on the card
    policy.set_policy("ref")
    try:
        plain = build_prefill_step(cfg)(params, {"tokens": prompts})
    finally:
        policy.set_policy("auto")
    diff = (plain - res["prefill_logits"]).abs().max().item()
    same = bool(torch.allclose(plain, res["prefill_logits"], atol=2e-3,
                               rtol=1e-3)) and bool(
        (plain.argmax(-1) == res["prefill_logits"].argmax(-1)).all())
    print(f"  prefill, kernel vs plain attention: max |diff| {diff:.3e}: "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        fail("prefill through the kernel disagrees with the plain path")
    where_the_time_goes(torch, cfg, params, prompts)
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

    print("== where the time goes (host clock; device time from "
          "torch.profiler)")
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
        top = sorted(zip(dev_ms, (e.key for e in kernels)), reverse=True)[:5]
        print(f"  {name}: host {wall:.3f} ms, device kernels {busy:.3f} ms "
              f"({busy / wall:.1%} busy), {sum(e.count for e in kernels) // n}"
              f" kernel launches")
        for ms, key in top:
            print(f"    {ms:8.3f} ms  {key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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

    worst, timing = phase_kernels(torch, fa, ref)
    launches = phase_serve(torch, fa, policy)

    t = timing["float32"]
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:114",
        "launches": launches, "max_abs_err": worst,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
