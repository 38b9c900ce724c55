"""Serve a batch of prompts with the port: prefill, cache fill, greedy decode.

    python -m repro_torch.serve [--arch qwen2-1.5b] [--reduced] [--batch 4]
        [--prompt-len 512] [--gen 32] [--device cuda] [--seed 0]

``--arch`` is any ported config: ``qwen2-1.5b`` (dense), ``mamba2-370m``
(SSD blocks) or ``recurrentgemma-9b`` (Griffin: RG-LRU and local attention).

Answers the batch the way the JAX serving pair does (``examples/serve.py``):

1. ``build_prefill_step`` over the prompts gives the first token's logits;
   on a GPU this is where the kernels run: flash attention once per
   attention layer, the SSD scan once per Mamba2 layer, the RG-LRU scan
   once per recurrent layer.
2. The caches are filled by teacher-forcing the prompt through
   ``build_decode_step``; the last of those logits must agree with
   prefill's (the decode-vs-forward equivalence of the JAX tests).
3. Greedy decode: the first token is the argmax of the prefill logits, and
   ``gen - 1`` decode steps give the rest.

Weights are random, drawn from ``--seed``; so are the prompts.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .configs import get_config
from .device import resolve_device
from .kernels import flash_attention, rglru_scan, ssd_scan
from .models.config import ModelConfig
from .models.model import init_decode_state, init_params
from .train.steps import build_decode_step, build_prefill_step

#: prefill vs teacher-forced decode logits, as ``tests/test_archs.py`` holds
#: the JAX decode path to the full forward
AGREE_ATOL, AGREE_RTOL = 2e-3, 1e-3

#: the kernel wrappers whose launch counts ``generate`` reports
KERNELS = {"flash": flash_attention, "ssd": ssd_scan, "rglru": rglru_scan}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def _since(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items()}


def generate(params, cfg: ModelConfig, prompts: torch.Tensor,
             gen: int) -> dict:
    """Serve ``prompts`` (B, P) and return the generated tokens (B, gen),
    the prefill and teacher-forced logits, the timings, and the launches
    of each kernel during prefill and over the whole run."""
    prefill = build_prefill_step(cfg)
    step = build_decode_step(cfg)
    dev = prompts.device
    B, P = prompts.shape

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    start = launch_counts()
    sync()
    t0 = time.perf_counter()
    prefill_logits = prefill(params, {"tokens": prompts})
    sync()
    prefill_s = time.perf_counter() - t0
    prefill_launches = _since(start)

    state = init_decode_state(cfg, B, P + gen, dtype=params["embed"].dtype,
                              device=dev)
    t0 = time.perf_counter()
    for t in range(P):
        logits, state = step(params, state, {"tokens": prompts[:, t:t + 1]})
    sync()
    fill_s = time.perf_counter() - t0
    teacher_logits = logits

    tok = prefill_logits.argmax(-1, keepdim=True)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, state = step(params, state, {"tokens": tok})
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
    sync()
    decode_s = time.perf_counter() - t0
    diff = (prefill_logits - teacher_logits).abs().max().item()
    return {
        "tokens": torch.cat(out, dim=1),
        "prefill_logits": prefill_logits,
        "teacher_logits": teacher_logits,
        "max_abs_diff": diff,
        "agree": bool(torch.allclose(prefill_logits, teacher_logits,
                                     atol=AGREE_ATOL, rtol=AGREE_RTOL))
        and bool((prefill_logits.argmax(-1)
                  == teacher_logits.argmax(-1)).all()),
        "prefill_ms": prefill_s * 1e3,
        "fill_ms": fill_s * 1e3,
        "decode_ms": decode_s * 1e3,
        "decode_tok_s": B * (gen - 1) / decode_s if gen > 1 else 0.0,
        "prefill_launches": prefill_launches,
        "launches": _since(start),
    }


def placement_report(cfg: ModelConfig) -> str:
    """The serving-time weight placement as a compiled ``repro_torch.api``
    strategy, as ``examples/serve.py`` reports it: TP4 serving replicas
    (the projections column-split over a 4-device group), switchable to a
    TP2 layout when half the serving pod is drained."""
    from . import api
    proj_shapes = {"wq": (cfg.d_model, cfg.d_model),
                   "wo": (cfg.d_model, cfg.d_model)}
    tp4 = api.Strategy("serve-tp4", {
        n: api.spmd([0, 1, 2, 3], api.DS({1: 4})) for n in proj_shapes})
    tp2 = api.Strategy("serve-tp2", {
        n: api.spmd([0, 1], api.DS({1: 2})) for n in proj_shapes})
    compiled = api.Program(api.weights_graph(proj_shapes),
                           [tp4, tp2]).compile("serve-tp4")
    drain = api.estimate_switch(
        [(n, tp4.annots[n], tp2.annots[n], proj_shapes[n], 2)
         for n in proj_shapes])
    return (f"serving placement: {compiled.strategy.name} over "
            f"{len(compiled.devices)} devices; drain to tp2 = "
            f"{drain.summary()}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-test variant of the config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.gen < 1 or args.prompt_len < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen must be >= 1")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, generator=generator, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(device)

    print(placement_report(cfg))
    res = generate(params, cfg, prompts, args.gen)
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"batch={args.batch} device={device}")
    print(f"prefill {args.prompt_len} tokens: {res['prefill_ms']:.3f} ms "
          f"(kernel launches {res['prefill_launches']}); "
          f"cache fill {res['fill_ms']:.1f} ms; decode {args.gen - 1} "
          f"steps: {res['decode_ms']:.1f} ms ({res['decode_tok_s']:.1f} "
          f"tok/s)")
    print(f"kernel launches over the whole run: {res['launches']}")
    print(f"prefill vs teacher-forced logits: max |diff| "
          f"{res['max_abs_diff']:.3e}, agree={res['agree']}")
    print("sample generation (token ids):",
          res["tokens"][0, :16].tolist())
    if not res["agree"]:
        raise SystemExit("prefill and teacher-forced decode logits disagree")
    return res


if __name__ == "__main__":
    main()
