"""Production training driver: the PyTorch counterpart of
``repro/launch/train.py``.

Selects an architecture config (``--arch``), initializes its parameters
from ``--seed``, prints the weight-placement and strategy-search report,
and runs real steps of ``build_train_step`` (microbatch accumulation,
remat, AdamW) on synthetic packed data, checkpointing periodically in the
JAX package's format.  On a GPU every forward runs the port's kernels
(flash attention, the SSD scan, the RG-LRU scan), and their backward is
the autograd of their plain versions.

  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 50 \\
      --batch 8 --seq 512 --microbatches 2
  python -m repro_torch.launch.train --device cpu --reduced --steps 3 \\
      --batch 4 --seq 128 --elastic-probe

``--reduced`` swaps in the smoke-scale variant of the config; ``--layers``
cuts the depth (an encoder-decoder's both stacks, :func:`cut_depth`) and
``--experts`` an MoE layer's routed experts, and both
keep every width (the reference's trainer has neither: they size a
published config to one card).  Each step runs under the smoke mesh
(``make_smoke_mesh()``, (data=1, model=1)), as the reference's does, so
that an MoE layer takes the expert-parallel formulation where the
reference's trainer does (4096 tokens a microbatch or more).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..checkpoint.store import restore, save
from ..configs import get_config
from ..data.pipeline import CorpusConfig, SyntheticCorpus, pack_batch
from ..device import resolve_device
from ..kernels import flash_attention, rglru_scan, ssd_scan
from ..models.model import init_params, token_embeds
from ..optim.adamw import AdamWConfig, init_opt_state
from ..sharding.hints import use_mesh
from ..train.steps import build_train_step
from ..tree import named_leaves
from .mesh import make_smoke_mesh

#: the kernel wrappers whose launches each step reports
KERNELS = {"flash": flash_attention, "ssd": ssd_scan, "rglru": rglru_scan}


def make_batch(corpus, cfg, batch, seq, rng, device):
    """One packed batch (tokens, labels, loss_mask, positions) on
    ``device``, as the reference's ``make_batch`` builds it: for embedding
    inputs the tokens become ``embeds`` = one_hot(token % d_model) * 0.02
    and ``positions3`` the positions on all three M-RoPE streams; for an
    encoder-decoder ``audio_embeds`` (batch, frames, d_model) are drawn
    from the numpy ``rng``, N(0, 0.02^2)."""
    seqs = corpus.sample_sequences(max(batch, 4))
    out = {k: torch.from_numpy(v).to(device)
           for k, v in pack_batch(seqs, batch, seq).items()}
    if cfg.input_kind == "embeds":
        tok = out.pop("tokens")
        out["embeds"] = token_embeds(tok, cfg.d_model)
        out["positions3"] = out["positions"][None].expand(
            (3,) + tuple(out["positions"].shape))
    elif cfg.input_kind == "audio":
        out["audio_embeds"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.encdec.n_frames, cfg.d_model))
            * 0.02).float().to(device)
    return out


def strategy_report(params, n_devices: int = 1, num_microbatches: int = 1,
                    cfg=None, global_batch: int = 8,
                    seq_len: int = 256) -> None:
    """Describe the run's weight placement through ``repro_torch.api``:
    the FSDP-style strategy over ``n_devices``, the pipeline schedule the
    microbatch count implies (grad accumulation is the single-stage 1F1B
    case), the fused-BSR cost of draining to half the devices, and -- with
    ``cfg`` -- the strategy search's pick for this device count
    (``repro_torch.search``: enumerate -> prune -> rank), as the reference
    reports them."""
    from .. import api

    leaves = list(named_leaves(params))
    shapes = {name: tuple(v.shape) for name, v in leaves}
    itemsizes = {name: v.element_size() for name, v in leaves}
    devices = list(range(n_devices))
    full = api.data_parallel_strategy("fsdp", devices, shapes)
    strategies = [full]
    if len(devices) >= 2:
        strategies.append(api.data_parallel_strategy(
            "fsdp-half", devices[:len(devices) // 2], shapes))
    prog = api.Program(api.weights_graph(shapes), strategies)
    plan = prog.compile("fsdp")
    print(f"placement[fsdp]: {len(shapes)} tensors over "
          f"{len(plan.devices)} device(s)")
    sched = plan.schedule(max(num_microbatches, 1), "1f1b")
    print(f"schedule[1f1b]: {plan.n_stages} stage(s) x "
          f"{sched.num_microbatches} microbatch(es) -> "
          f"{sched.stats().summary()}")
    if len(devices) >= 2:
        half = prog.strategy("fsdp-half")
        report = api.estimate_switch(
            [(n, full.annots[n], half.annots[n], shapes[n], itemsizes[n])
             for n in shapes])
        print(f"elastic drain to {len(devices) // 2} device(s): "
              f"{report.summary()}")
    if cfg is not None:
        from ..core.costmodel import ModelSpec
        from ..search import SearchError, Searcher, cpu_cluster
        spec = ModelSpec(cfg.name, cfg.n_layers, cfg.d_model,
                         getattr(cfg, "d_ff", 4 * cfg.d_model),
                         vocab=cfg.vocab)
        searcher = Searcher(spec, global_batch=global_batch,
                            seq_len=seq_len, tp_options=(1, 2),
                            pp_options=(1, 2, 4),
                            include_hetero=len(devices) > 1)
        try:
            result = searcher.search(cpu_cluster(len(devices)))
            print(f"strategy search over {len(devices)} device(s): "
                  f"{result.prune_report.summary()}")
            print(f"  winner {result.best.describe()}")
        except SearchError as exc:
            print(f"strategy search over {len(devices)} device(s): "
                  f"{exc}")


def elastic_probe_report(device) -> None:
    """Run the elastic probe trace live (``repro_torch.elastic``): real
    ``train_step``s on ``TorchExecutor(device)`` through a shrink -> grow
    -> class-change trace, each switch migrating weights and AdamW m/v on
    the torch comm lowering, and print what each transition cost, as the
    reference's ``elastic_probe_report`` does."""
    from .. import api
    from ..elastic import ElasticDriver
    from ..elastic.fixtures import (probe_feeds, probe_graph,
                                    probe_provider, probe_values)

    driver = ElasticDriver(probe_graph(), probe_values(),
                           probe_provider(), probe_feeds,
                           executor=api.TorchExecutor(device),
                           num_microbatches=2)
    run = driver.run([(0, (0, 1, 2, 3), "dp"), (2, (0, 1), "dp"),
                      (4, (0, 1, 2, 3), "pp")], 6)
    print(f"elastic probe: {run.summary()}")


def cut_depth(cfg, layers: int):
    """``cfg`` with its depth cut to ``layers``, every width kept: the
    decoder stack, and an encoder-decoder's encoder stack too."""
    cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.encdec:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, n_enc_layers=layers))
    return cfg


def main(argv=None) -> dict:
    """Train and return the run's numbers: per-step losses, gradient
    norms, learning rates, step times (ms, the device synchronized at each
    step's end) and kernel launches, tokens a second and peak device
    memory (GiB, CUDA only)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept)")
    ap.add_argument("--experts", type=int, default=None,
                    help="cut an MoE layer's routed experts to this many "
                         "(top-k, expert width, shared and dense layers "
                         "kept)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--strategy-report", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="print the repro_torch.api weight-placement and "
                         "strategy-search summary at startup "
                         "(--no-strategy-report skips the planning it "
                         "costs)")
    ap.add_argument("--elastic-probe", action="store_true",
                    help="also run the live elastic probe trace "
                         "(repro_torch.elastic: shrink/grow/class-change "
                         "with fused-BSR migration on the device) and "
                         "print per-transition costs before training "
                         "starts")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.batch % args.microbatches:
        ap.error("--batch must be a multiple of --microbatches")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    if args.experts is not None:
        if cfg.moe is None:
            ap.error(f"--experts: {cfg.name} has no MoE layers")
        if args.experts < cfg.moe.top_k:
            ap.error(f"--experts {args.experts} is below {cfg.name}'s "
                     f"top_k of {cfg.moe.top_k}")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=args.experts))
    print(f"arch={cfg.name} ({cfg.family}) layers={cfg.n_layers} "
          + (f"enc_layers={cfg.encdec.n_enc_layers} " if cfg.encdec else "")
          + (f"experts={cfg.moe.n_experts} " if cfg.moe else "")
          + f"d={cfg.d_model} params~{cfg.param_count() / 1e6:.1f}M "
          f"device={device}")

    params = init_params(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(args.seed))
    if args.strategy_report:
        strategy_report(params, 1, num_microbatches=args.microbatches,
                        cfg=cfg, global_batch=args.batch, seq_len=args.seq)
    if args.elastic_probe:
        elastic_probe_report(device)
    opt_state = init_opt_state(params)
    start = 0
    if args.resume:
        (params, opt_state), start = restore(args.resume,
                                             (params, opt_state))
        print(f"resumed from {args.resume} @ step {start}")

    step_fn = build_train_step(cfg, AdamWConfig(lr=args.lr),
                               num_microbatches=args.microbatches)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, max_len=args.seq,
                                          seed=args.seed))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "experts": cfg.moe.n_experts if cfg.moe else None,
           "device": str(device),
           "losses": [], "grad_norms": [], "lrs": [], "step_ms": [],
           "launches": []}
    rng = np.random.default_rng(0)
    # the step under the smoke mesh, as the reference runs it (its
    # param_specs there are computed and never used: not copied)
    mesh = make_smoke_mesh()
    sync()
    t0 = time.time()
    for step in range(start, start + args.steps):
        before = {k: mod.launches for k, mod in KERNELS.items()}
        batch = make_batch(corpus, cfg, args.batch, args.seq, rng, device)
        t_step = time.perf_counter()
        with use_mesh(mesh):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        sync()
        out["step_ms"].append((time.perf_counter() - t_step) * 1e3)
        out["launches"].append({k: mod.launches - before[k]
                                for k, mod in KERNELS.items()})
        loss = float(metrics["loss"])
        gn = float(metrics["grad_norm"])
        out["losses"].append(loss)
        out["grad_norms"].append(gn)
        out["lrs"].append(float(metrics["lr"]))
        if step % args.log_every == 0 or step == start + args.steps - 1:
            dt = time.time() - t0
            tput = (step - start + 1) * args.batch * args.seq / dt
            print(f"step {step:5d} loss {loss:8.4f} gnorm {gn:8.3f} "
                  f"{tput:8.0f} tok/s")
        if args.ckpt and step and step % 100 == 0:
            save(args.ckpt, (params, opt_state), step, {"arch": cfg.name})
    out["tokens_per_s"] = args.steps * args.batch * args.seq / (
        time.time() - t0)
    out["peak_memory_gib"] = (torch.cuda.max_memory_allocated(device)
                              / 2**30 if device.type == "cuda" else None)
    if args.ckpt:
        save(args.ckpt, (params, opt_state), start + args.steps,
             {"arch": cfg.name})
        print(f"checkpoint -> {args.ckpt}")
    return out


if __name__ == "__main__":
    main()
