"""Roofline terms by components: the PyTorch counterpart of
``repro/launch/roofline.py``.

A full step repeats a few components many times (microbatches x layers),
so each component runs once on the production mesh -- fake world, DTensors
placed by the production rules, fake tensors, counted by
:class:`~.hardware.DeviceCounter` as in :mod:`.dryrun` -- and its costs are
multiplied by its exact trip count:

  layer:<kind>   one block, forward (+ backward with remat for train)
  encoder_layer  (encoder-decoder archs)
  embed_head     embedding lookup + final norm + LM head (+ loss & bwd)
  optimizer      AdamW over the whole parameter tree

total = sum(component cost x trip count).  MODEL_FLOPS = 6 N_active D
(train) or 2 N D (serving) is reported beside it, with the useful share of
the counted FLOPs and the MFU the roofline bound implies on the card.

  python -m repro_torch.launch.roofline --arch qwen2-1.5b --shape train_4k \\
      --gpu h100-sxm [--multi-pod] [--all] [--json out.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.utils.checkpoint import checkpoint

from ..configs import get_config
from ..kernels import policy
from ..models.model import _empty_cache_block, apply_block, layer_groups
from ..optim.adamw import AdamWConfig, apply_updates
from ..sharding.rules import P, decode_state_specs, param_specs
from ..tree import tree_map
from .dryrun import (assigned_archs, axis_of_group, build_step_and_args,
                     moe_formulation, place, production_mesh, report)
from .hardware import DeviceCounter, get_gpu
from .mesh import LogicalMesh, make_production_mesh
from .specs import (INPUT_SHAPES, META, decode_state_structs, input_specs,
                    shape_applicable)

N_MICRO = 8


def _strip(specs):
    """Specs of one layer of a stacked tree: the leading layer dim off."""
    if isinstance(specs, dict):
        return {k: _strip(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_strip(v) for v in specs]
    return P(*tuple(specs)[1:])


def _one(tree):
    return tree_map(lambda a: a[0] if torch.is_tensor(a) else a, tree)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


def _run(mesh, fm_dm, fn, args, specs) -> dict:
    """``fn(*args)`` once on DTensors placed by ``specs``, counted."""
    dm, fm = fm_dm
    placed = place(list(args), list(specs), dm)
    counter = DeviceCounter(axis_of_group(dm), fm)
    counter.track(placed)
    with counter:
        out = fn(*placed)
        del out
    return counter.totals()


def _bspec(mesh, batch):
    bd = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    nb = 1
    for a in bd:
        nb *= mesh.shape[a]
    return bd if bd and batch % nb == 0 else None


def layer_component(cfg, kind, gname, mesh, ctx_mesh, batch, seq, mode,
                    params_struct, layout="train", dtype=torch.bfloat16):
    """One block of group ``gname`` (forward; + backward under remat for
    ``"train"``; one decode step over a cache for ``"decode"``)."""
    d = cfg.d_model
    bs = _bspec(mesh, batch)
    full = param_specs(params_struct, cfg, mesh, mode=layout)
    lp = _one(params_struct["groups"][gname])
    lspec = _strip(full["groups"][gname])
    enc = cfg.encdec is not None and kind == "dec"
    s = 1 if mode == "decode" else seq
    args = [lp, _meta((batch, s, d), dtype),
            _meta((batch, s), torch.int64)]
    specs = [lspec, P(bs, None, None), P(bs, None)]
    if mode == "decode":
        stacked = _empty_cache_block(cfg, kind, 1, batch, seq, dtype, META)
        cspec = decode_state_specs({"caches": {gname: stacked}}, cfg,
                                   mesh)["caches"][gname]
        args.append(_one(stacked))
        specs.append(_strip(cspec))
    if enc:
        args.append(_meta((batch, cfg.encdec.n_frames, d), dtype))
        specs.append(P(bs, None, None))

    def ctx_of(pos, rest):
        ctx = {"positions": pos, "causal": True}
        if enc:
            ctx["enc_out"] = rest[-1]
        return ctx

    if mode == "train":
        def f(lp, x, pos, *rest):
            x.requires_grad_(True)
            ctx = ctx_of(pos, rest)

            def inner(lp, x):
                y, _, aux = apply_block(lp, x, cfg, kind, ctx)
                out = torch.sum(y.float())
                return out + aux if aux is not None else out
            from ..tree import tree_leaves
            leaves = [t for t in tree_leaves(lp) if torch.is_tensor(t)]
            for t in leaves:
                t.requires_grad_(True)
            loss = checkpoint(inner, lp, x, use_reentrant=False,
                              preserve_rng_state=False)
            return torch.autograd.grad(loss, leaves + [x])
    elif mode == "prefill":
        def f(lp, x, pos, *rest):
            with torch.no_grad():
                return apply_block(lp, x, cfg, kind, ctx_of(pos, rest))[0]
    else:
        def f(lp, x, pos, cache, *rest):
            with torch.no_grad():
                return apply_block(lp, x, cfg, kind, ctx_of(pos, rest),
                                   cache=cache)[:2]
    return _run(mesh, ctx_mesh, f, args, specs)


def head_component(cfg, mesh, ctx_mesh, batch, seq, mode, params_struct,
                   layout="train", dtype=torch.bfloat16):
    """Embedding lookup + final norm + head (+ loss and backward when
    training on tokens); serving heads see only the sampled position."""
    bs = _bspec(mesh, batch)
    d = cfg.d_model
    s = seq if mode == "train" else 1
    keys = [k for k in ("embed", "lm_head", "final_norm")
            if k in params_struct]
    sub = {k: params_struct[k] for k in keys}
    full = param_specs(params_struct, cfg, mesh, mode=layout)
    sub_specs = {k: full[k] for k in keys}
    from ..models.model import _head, _sharded_lse_and_pick
    from ..sharding.hints import batch_axes, gather_weights, hint

    if mode == "train" and cfg.input_kind == "tokens":
        def f(pp, tokens, h, labels):
            h.requires_grad_(True)
            leaves = list(pp.values())
            leaves = [t for v in leaves for t in
                      (v.values() if isinstance(v, dict) else [v])]
            for t in leaves:
                t.requires_grad_(True)
            x = torch.nn.functional.embedding(
                tokens, gather_weights(pp["embed"])) + h
            # the forward's and the loss's head, hints included
            logits = hint(_head(pp, x, cfg), batch_axes(), None, "model")
            logits = hint(logits.float(), batch_axes(), None, "model")
            lse, picked = _sharded_lse_and_pick(logits, labels.long())
            loss = torch.mean(lse - picked)
            return torch.autograd.grad(loss, leaves + [h])

        args = [sub, _meta((batch, s), torch.int64),
                _meta((batch, s, d), dtype), _meta((batch, s), torch.int64)]
        specs = [sub_specs, P(bs, None), P(bs, None, None), P(bs, None)]
    else:
        def f(pp, h):
            with torch.no_grad():
                return hint(_head(pp, h, cfg), batch_axes(), None, "model")

        args = [sub, _meta((batch, s, d), dtype)]
        specs = [sub_specs, P(bs, None, None)]
    return _run(mesh, ctx_mesh, f, args, specs)


def optimizer_component(cfg, mesh, ctx_mesh, params_struct):
    """AdamW over the whole parameter tree (gradients as the parameters)."""
    from .specs import opt_structs
    pspecs = param_specs(params_struct, cfg, mesh)
    opt = opt_structs(params_struct)
    ospecs = {"m": pspecs, "v": pspecs, "count": P()}

    def f(p, g, o):
        return apply_updates(p, g, o, AdamWConfig())

    return _run(mesh, ctx_mesh, f, [params_struct, params_struct, opt],
                [pspecs, pspecs, ospecs])


def moe_component(cfg, mesh, tokens: int, dtype=torch.float32) -> dict:
    """One MoE layer (``apply_moe``) forward on ``tokens`` tokens at
    ``dtype``, on the fake ``mesh``: what one device's program of the
    expert-parallel formulation does."""
    from ..models.moe import apply_moe, init_moe
    params = {"moe": init_moe(None, cfg, dtype, META)}
    pspec = param_specs(params, cfg, mesh)
    bs = _bspec(mesh, 1)
    x = _meta((1, tokens, cfg.d_model), dtype)
    prev = policy.get_policy()
    policy.set_policy("ref")
    try:
        with production_mesh(mesh) as ctx_mesh:
            def f(pp, x):
                with torch.no_grad():
                    return apply_moe(pp["moe"], x, cfg)
            return _run(mesh, ctx_mesh, f, [params, x],
                        [pspec, P(bs, None, None)])
    finally:
        policy.set_policy(prev)


def _scaled_sum(components):
    keys = ("flops", "hbm_bytes", "collective_bytes")
    tot = {k: 0.0 for k in keys}
    by = {"flops_by_dtype": {}, "collectives": {}, "collectives_by_axis": {}}
    for _, m, c in components:
        for k in keys:
            tot[k] += m * c[k]
        for k in by:
            for kk, v in c[k].items():
                by[k][kk] = by[k].get(kk, 0.0) + m * v
    return {**tot, **by}


def roofline(arch: str, shape_name: str, *, multi_pod: bool = False,
             gpu: str = "h100-sxm", mesh: LogicalMesh | None = None,
             cfg=None, verbose: bool = True) -> dict:
    card = get_gpu(gpu)
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    _, specs = input_specs(cfg, shape_name)
    params_struct = specs["params"]
    mode = shape.kind
    if mode == "train":
        mb, mult, seq = shape.global_batch // N_MICRO, N_MICRO, shape.seq_len
    else:
        mb, mult, seq = shape.global_batch, 1, shape.seq_len
    layout = "train"
    if mode == "decode":
        from ..sharding.rules import serve_mode_fits
        if serve_mode_fits(params_struct, decode_state_structs(cfg, shape),
                           mesh):
            layout = "serve"
    prev = policy.get_policy()
    policy.set_policy("ref")
    components = []
    try:
        with production_mesh(mesh) as ctx_mesh:
            # the step's inputs per device, placed as the dry run places them
            _, args, _ = build_step_and_args(cfg, shape, mesh, ctx_mesh[0])
            step_args = DeviceCounter().track(args)
            del args
            for gi, (kind, count) in enumerate(layer_groups(cfg)):
                c = layer_component(cfg, kind, f"g{gi}_{kind}", mesh,
                                    ctx_mesh, mb, seq, mode, params_struct,
                                    layout)
                components.append((f"layer:{kind}", count * mult, c))
            if cfg.encdec and mode != "decode":
                c = layer_component(
                    cfg, "enc", "encoder", mesh, ctx_mesh, mb,
                    cfg.encdec.n_frames,
                    "prefill" if mode != "train" else "train",
                    {"groups": {"encoder": params_struct["encoder"]}})
                components.append(("encoder_layer",
                                    cfg.encdec.n_enc_layers * mult, c))
            components.append(("embed_head", mult, head_component(
                cfg, mesh, ctx_mesh, mb, seq, mode, params_struct, layout)))
            if mode == "train":
                components.append(("optimizer", 1, optimizer_component(
                    cfg, mesh, ctx_mesh, params_struct)))
    finally:
        policy.set_policy(prev)
    costs = _scaled_sum(components)
    temps = max(c["peak_bytes"] - c["argument_bytes"]
                for _, _, c in components)
    tokens = shape.global_batch * (1 if mode == "decode" else shape.seq_len)
    n_active = cfg.param_count(active_only=True)
    model_flops = (6 if mode == "train" else 2) * n_active * tokens
    rep = report(costs, card, mesh)
    bound = max(rep["roofline_seconds"].values())
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh.label(),
        "chips": mesh.size, "gpu": card.name, "layout": layout,
        "run_s": round(time.time() - t0, 2),
        # the step's inputs and the largest component's temporaries: the
        # step's own peak also holds what remat keeps of every layer
        "bytes_per_device": {"arguments": step_args,
                             "largest_component_temps": temps,
                             "estimate": step_args + temps},
        "per_device": costs, **rep,
        "model_flops_global": model_flops,
        "useful_flops_ratio": model_flops / (costs["flops"] * mesh.size)
        if costs["flops"] else 0.0,
        # MODEL_FLOPS over what the chips could do at bf16 peak while the
        # roofline bound runs
        "mfu_at_bound": model_flops / (mesh.size * bound
                                       * card.peak_flops["bfloat16"])
        if bound else 0.0,
        "components": [{"name": n, "mult": m, **c}
                       for n, m, c in components],
    }
    moe = moe_formulation(cfg, mesh, shape, mult)
    if moe is not None:
        result["moe"] = moe
    if verbose:
        terms = result["roofline_seconds"]
        print(f"[{arch} x {shape_name} @ {result['mesh']} on {card.key}] "
              + ", ".join(f"{k}={v * 1e3:.2f}ms" for k, v in terms.items())
              + f" -> {result['bottleneck']} | useful-flops ratio "
              f"{result['useful_flops_ratio']:.2f} | MFU at bound "
              f"{result['mfu_at_bound']:.3f} ({result['run_s']:.1f}s)")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--gpu", required=True,
                    help="the card whose constants the terms take (h100-sxm)")
    args = ap.parse_args(argv)
    try:
        get_gpu(args.gpu)
    except KeyError as exc:
        ap.error(str(exc.args[0]))
    if args.all:
        combos = [(a, s) for a in assigned_archs() for s in INPUT_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        combos = [(args.arch, args.shape)]
    failed = 0
    for arch, shape in combos:
        try:
            r = roofline(arch, shape, multi_pod=args.multi_pod, gpu=args.gpu)
        except Exception as e:  # noqa: BLE001 -- report and go on
            print(f"[{arch} x {shape}] FAILED: {type(e).__name__}: {e}")
            r = {"arch": arch, "shape": shape,
                 "error": f"{type(e).__name__}: {e}"}
            failed += 1
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(r) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
