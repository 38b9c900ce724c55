"""Serve a batch of prompts with the port: prefill, cache fill, greedy decode.

    python -m repro_torch.serve [--arch qwen2-1.5b] [--reduced] [--batch 4]
        [--prompt-len 512] [--gen 32] [--device cuda] [--seed 0]

``--arch`` is any config of ``repro_torch.configs``: dense ones such as
``qwen2-1.5b``, ``mamba2-370m`` (SSD blocks), ``recurrentgemma-9b``
(Griffin: RG-LRU and local attention), ``deepseek-v2-236b`` (MLA and MoE),
``grok-1-314b`` (MoE), ``qwen2-vl-72b`` (embedding inputs with M-RoPE
positions) and ``whisper-large-v3`` (audio encoder-decoder).

Answers the batch the way the JAX serving pair does (``examples/serve.py``):

1. ``build_prefill_step`` over the prompts gives the first token's logits;
   on a GPU this is where the kernels run: flash attention once per
   attention layer whose shapes pass the JAX package's gate (not Whisper's
   encoder or cross-attention over 1500 frames), the SSD scan once per
   Mamba2 layer, the RG-LRU scan once per recurrent layer.
2. The caches are filled by teacher-forcing the prompt through
   ``build_decode_step``; the last of those logits must agree with
   prefill's (the decode-vs-forward equivalence of the JAX tests).
3. Greedy decode: the first token is the argmax of the prefill logits, and
   ``gen - 1`` decode steps give the rest.

Weights are random, drawn from ``--seed``; so are the prompts
(:func:`make_prompt`: tokens, or for Qwen2-VL embeddings of an image grid
and text with their M-RoPE ids, and for Whisper audio frames beside the
tokens).  With an MoE config the teacher-forced decode agrees with prefill
only where no assignment is dropped, as under ``moe.exact`` (at
``capacity_factor`` 1.25 a 4-token decode step has a capacity of 1).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from .configs import get_config
from .device import resolve_device
from .kernels import flash_attention, rglru_scan, ssd_scan
from .models.config import ModelConfig
from .models.model import (init_decode_state, init_params, run_encoder,
                           token_embeds)
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


def vlm_positions3(batch: int, prompt_len: int, device=None):
    """Qwen2-VL's M-RoPE ids for a prompt of an image and then text
    (3, batch, prompt_len): the first g x g positions are the image's
    patch grid (t = 0, h = row, w = column), with g = 16 (256 patches) or
    less where the prompt is shorter than 2 g^2; the text follows, counting
    from g on all three streams."""
    g = min(16, math.isqrt(prompt_len // 2))
    r = torch.arange(g * g, device=device)
    image = torch.stack([torch.zeros_like(r), r // g, r % g])
    text = torch.arange(g, g + prompt_len - g * g,
                        device=device).expand(3, -1)
    return torch.cat([image, text], dim=1)[:, None].expand(
        3, batch, prompt_len)


def make_prompt(cfg: ModelConfig, batch: int, prompt_len: int, rng,
                device) -> dict:
    """The prefill batch for the config's input kind, drawn from the numpy
    ``rng``: ``tokens`` (batch, prompt_len); for embedding inputs instead
    ``embeds`` N(0, 0.02^2) and :func:`vlm_positions3`; for an
    encoder-decoder also ``audio_embeds`` (batch, frames, d) N(0, 0.02^2),
    as the JAX trainer draws them."""
    d = cfg.d_model
    if cfg.input_kind == "embeds":
        embeds = rng.standard_normal((batch, prompt_len, d)) * 0.02
        return {"embeds": torch.from_numpy(embeds).float().to(device),
                "positions3": vlm_positions3(batch, prompt_len, device)}
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt_len))).to(device)}
    if cfg.input_kind == "audio":
        frames = rng.standard_normal((batch, cfg.encdec.n_frames, d)) * 0.02
        out["audio_embeds"] = torch.from_numpy(frames).float().to(device)
    return out


def decode_batch(cfg: ModelConfig, prompt: dict, t: int) -> dict:
    """Position ``t`` of the prompt as one decode step's batch."""
    if cfg.input_kind == "embeds":
        return {"embeds": prompt["embeds"][:, t:t + 1],
                "positions3": prompt["positions3"][:, :, t:t + 1]}
    return {"tokens": prompt["tokens"][:, t:t + 1]}


def generate(params, cfg: ModelConfig, prompt: dict, gen: int) -> dict:
    """Serve ``prompt`` (a batch from :func:`make_prompt`: ``tokens`` (B, P),
    or ``embeds`` and ``positions3``) and return the generated tokens
    (B, gen), the prefill and teacher-forced logits, the timings, and the
    launches of each kernel during prefill and over the whole run.  An
    encoder-decoder runs its encoder once over the audio frames for the
    decode state (``encode_ms``); its prefill runs the encoder itself, as
    the model's forward does."""
    prefill = build_prefill_step(cfg)
    step = build_decode_step(cfg)
    lead = prompt.get("tokens", prompt.get("embeds"))
    dev = lead.device
    B, P = lead.shape[:2]
    dtype = params["final_norm"]["w"].dtype

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    start = launch_counts()
    sync()
    t0 = time.perf_counter()
    prefill_logits = prefill(params, prompt)
    sync()
    prefill_s = time.perf_counter() - t0
    prefill_launches = _since(start)

    enc_out, encode_s = None, 0.0
    if cfg.encdec:
        t0 = time.perf_counter()
        with torch.inference_mode():
            enc_out = run_encoder(params, prompt, cfg)
        sync()
        encode_s = time.perf_counter() - t0
    state = init_decode_state(cfg, B, P + gen, dtype=dtype, device=dev,
                              enc_out=enc_out)
    t0 = time.perf_counter()
    for t in range(P):
        logits, state = step(params, state, decode_batch(cfg, prompt, t))
    sync()
    fill_s = time.perf_counter() - t0
    teacher_logits = logits

    tok = prefill_logits.argmax(-1, keepdim=True)
    out = [tok]
    next_pos = (prompt["positions3"][:, :, -1:] + 1
                if cfg.input_kind == "embeds" else None)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        if next_pos is None:
            batch = {"tokens": tok}
        else:
            batch = {"embeds": token_embeds(tok, cfg.d_model, dtype),
                     "positions3": next_pos + i}
        logits, state = step(params, state, batch)
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
        "encode_ms": encode_s * 1e3,
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
    prompt = make_prompt(cfg, args.batch, args.prompt_len,
                         np.random.default_rng(args.seed), device)

    print(placement_report(cfg))
    res = generate(params, cfg, prompt, args.gen)
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
