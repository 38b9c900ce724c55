"""One MoE layer expert-parallel over real ranks, against the
single-process capacity dispatch.

    python -m repro_torch.launch.moe_ep --arch deepseek-v2-236b \\
        --tokens 4096 --data 1 --model 4 --backend gloo --device cuda

Run once per rank (``repro_torch.runtime.harness.run_ranks``): the ranks
form a (data, model) mesh (:meth:`~.mesh.LogicalMesh.rank_groups`), and
each calls :func:`repro_torch.models.moe.apply_moe` under
``hints.use_mesh(mesh, ranks=...)`` on its batch shard, holding only its
own E / model experts.  Every expert is drawn from a seed of its own, so no
rank builds the others'.  Each rank checks its routing (``top_e`` and the
assignments its experts keep) bitwise against the single-process dispatch's
routing of its tokens; rank 0 also builds every expert and runs the
single-process dispatch (``_apply_moe_gspmd``) on each batch shard, and
holds the ranks' outputs (normwise) and aux loss to it.  Rank 0 prints one
line ``MOE_EP_JSON {...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch
import torch.distributed as dist

from ..configs import get_config
from ..models import moe
from ..models.layers import _init
from ..sharding import hints
from .mesh import LogicalMesh, make_runtime_mesh


def expert(cfg, e: int, seed: int, device):
    """Expert ``e``'s MLP weights, from a seed of its own."""
    from ..models.layers import init_mlp
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + 1 + e)
    return init_mlp(g, cfg.d_model, cfg.moe.d_expert, cfg.mlp, torch.float32,
                    device)


def layer(cfg, experts: range, seed: int, device):
    """Router, the experts in ``experts`` (stacked) and the shared ones."""
    g = torch.Generator(device=device).manual_seed(seed)
    m = cfg.moe
    p = {"router": _init(g, (cfg.d_model, m.n_experts), torch.float32,
                         device)}
    if m.n_shared:
        p["shared"] = moe._stacked_mlp(g, m.n_shared, cfg.d_model,
                                       m.d_expert, cfg.mlp, torch.float32,
                                       device)
    first = expert(cfg, experts[0], seed, device)
    stacked = {k: v.new_empty((len(experts),) + v.shape)
               for k, v in first.items()}
    for i, e in enumerate(experts):
        one = first if i == 0 else expert(cfg, e, seed, device)
        for k, v in one.items():
            stacked[k][i] = v
        del one
    p["experts"] = stacked
    return p


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-236b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--exact", action="store_true",
                    help="no drops (capacity = tokens)")
    ap.add_argument("--tokens", type=int, default=4096,
                    help="tokens of the whole batch")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    ranks = make_runtime_mesh(args.data * args.model, backend=args.backend,
                              device=args.device)
    out = run(ranks, args)
    if out is not None:
        print("MOE_EP_JSON " + json.dumps(out), flush=True)
    return 0


def run(ranks, args) -> dict | None:
    """The check on this rank of ``ranks`` (a RankMesh of data x model
    ranks) -> rank 0's report, None elsewhere.  Collective: every rank
    calls it."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, exact=args.exact))
    mesh = LogicalMesh(("data", "model"), (args.data, args.model))
    dev = ranks.device
    m = cfg.moe
    coords = mesh.coords(ranks.rank)
    e_loc = m.n_experts // args.model
    lo = coords["model"] * e_loc
    t_loc = args.tokens // args.data
    gx = torch.Generator(device=dev).manual_seed(args.seed + 7)
    x_all = torch.randn((args.tokens, cfg.d_model), generator=gx,
                        device=dev)
    x = x_all[coords["data"] * t_loc:(coords["data"] + 1) * t_loc]

    t0 = time.perf_counter()
    p = layer(cfg, range(lo, lo + e_loc), args.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_build = time.perf_counter() - t0
    moe.staged_bytes.clear()
    moe.routing_log = []
    dist.barrier()
    t0 = time.perf_counter()
    with hints.use_mesh(mesh, ranks=ranks):
        y, aux = moe.apply_moe(p, x[None], cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_ep = time.perf_counter() - t0
    (top_e, keep), = moe.routing_log
    moe.routing_log = None
    # this rank's card peak through the expert-parallel call (the ranks
    # share one card: each process counts its own allocations)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None

    # the routing of this rank's tokens, as the single-process dispatch
    # routes them (only the router is needed), held bitwise
    ref_top, ref_keep = _routing_only(p["router"], x, cfg)
    mine = (ref_top >= lo) & (ref_top < lo + e_loc)
    routing_ok = bool(torch.equal(top_e, ref_top)
                      and torch.equal(keep, ref_keep & mine))
    flags = torch.tensor([int(routing_ok)], dtype=torch.int64)
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    routing_all = bool(flags.item())

    # rank 0: every rank's output (each data shard's), then the reference
    ys = [torch.empty_like(y.reshape(t_loc, -1).cpu())
          for _ in range(mesh.size)] if ranks.rank == 0 else None
    dist.gather(y.reshape(t_loc, -1).cpu(), ys, dst=0)
    out = None
    if ranks.rank == 0:
        del p
        t0 = time.perf_counter()
        full = layer(cfg, range(m.n_experts), args.seed, dev)
        t_ref_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        worst, auxes = 0.0, []
        for i in range(args.data):
            xi = x_all[i * t_loc:(i + 1) * t_loc]
            yr, ar = moe._apply_moe_gspmd(full, xi[None], cfg)
            auxes.append(ar)
            want = yr.reshape(t_loc, -1).double()
            for j in range(args.model):
                got = ys[mesh.devices[i, j]].to(dev).double()
                worst = max(worst, ((got - want).norm()
                                    / want.norm()).item())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_ref = time.perf_counter() - t0
        aux_ref = torch.stack(auxes).mean()
        out = {"mesh": mesh.label(), "tokens": args.tokens,
               "experts_per_rank": e_loc, "exact": args.exact,
               "routing_bitwise": routing_all, "y_normwise": worst,
               "aux": aux.item(), "aux_ref": aux_ref.item(),
               "aux_rel": abs(aux.item() - aux_ref.item())
               / abs(aux_ref.item()),
               "staged_bytes": moe.staged_bytes[0] if moe.staged_bytes
               else 0,
               "ep_s": t_ep, "build_s": t_build, "ref_build_s": t_ref_build,
               "ref_s": t_ref, "rank_peaks_bytes": None}
    peaks = [None] * ranks.world
    dist.all_gather_object(peaks, peak)
    if out is not None:
        out["rank_peaks_bytes"] = peaks
        del full
    dist.barrier()
    return out


def _routing_only(router, xt, cfg):
    """(top_e, keep) of the single-process dispatch of ``xt``, computed
    from the router alone: the same steps as ``_apply_moe_gspmd``."""
    m = cfg.moe
    _, _, top_e = moe._route(xt, router, m)
    keep = moe.positions(top_e.reshape(-1), m.n_experts) \
        < moe.capacity(xt.shape[0], m)
    return top_e, keep.reshape(top_e.shape)


if __name__ == "__main__":
    sys.exit(main())
