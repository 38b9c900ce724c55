"""The production dry run: the PyTorch counterpart of
``repro/launch/dryrun.py``.

For an (architecture x input shape), the step of
:func:`build_step_and_args` (train: AdamW over 8 microbatches; prefill;
decode, in the weight-stationary serve layout when it fits) runs once on
the production mesh -- 16x16, or 2x16x16 with ``--multi-pod`` -- with no
allocation: a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``), a ``DeviceMesh`` on
it, the inputs as DTensors placed by :mod:`repro_torch.sharding.rules`,
and every tensor fake (``FakeTensorMode``).  :class:`~.hardware.
DeviceCounter` counts what device 0's program does: memory (arguments,
outputs, temps, peak), matmul FLOPs, HBM bytes and collective bytes by
kind, which give the three roofline terms on the card named by ``--gpu``.

The step runs the plain versions of the kernels (policy ``"ref"``), as
the reference lowers its XLA path: the plain attention forms the (B, H,
S, S) scores that flash attention (B1) never holds, so ``temps`` and HBM
bytes are those of the plain path, above what the kernel path needs.

  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k \\
      --gpu h100-sxm [--multi-pod] [--all] [--json out.jsonl]

The fake world is torn down after every run, an error included, so that
``torch.distributed.is_initialized()`` is False again.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch
import torch.distributed as dist

from ..configs import ARCHS, get_config
from ..kernels import policy
from ..models.moe import DTENSOR_FORMULATIONS, dtensor_formulation
from ..optim.adamw import AdamWConfig
from ..sharding import hints
from ..sharding.rules import (P, batch_specs, decode_state_specs,
                              param_specs, serve_mode_fits, to_placements)
from ..train.steps import (build_decode_step, build_prefill_step,
                           build_train_step)
from .hardware import DeviceCounter, axis_links, get_gpu, roofline_terms
from .mesh import LogicalMesh, make_production_mesh
from .specs import INPUT_SHAPES, InputShape, input_specs, shape_applicable

N_MICRO = 8
#: a note every report carries: what the plain attention costs
PLAIN_ATTENTION_NOTE = (
    "plain versions of the kernels: the plain attention's (B, H, S, S) "
    "scores inflate temps and HBM bytes beside flash attention (B1), "
    "which never holds them")


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0: its
    collectives return at once and move nothing.  Torn down on exit, an
    error included."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is initialized already; the dry "
                           "run makes its own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def production_mesh(mesh: LogicalMesh):
    """Fake world, DeviceMesh, fake tensors and the active mesh of the
    hints, for as long as the context lasts -> (the DeviceMesh, the
    FakeTensorMode)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_world(mesh.size):
        dm = mesh.device_mesh("cpu")
        with FakeTensorMode(allow_non_fake_inputs=True) as fm, \
                hints.use_mesh(mesh, device_mesh=dm):
            yield dm, fm


def axis_of_group(dm) -> dict[str, tuple[str, int]]:
    """Each mesh dim's process-group name -> (the dim's axis name, its
    size)."""
    return {dm.get_group(i).group_name: (name, dm.shape[i])
            for i, name in enumerate(dm.mesh_dim_names)}


def local_shape(shape, placements, dm) -> tuple[int, ...]:
    """Device 0's shard of a tensor of ``shape``: each ``Shard(d)`` cuts
    dim ``d`` into the mesh dim's size, the first piece the largest (as
    ``torch.chunk`` cuts)."""
    out = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            out[pl.dim] = -(-out[pl.dim] // dm.shape[i])
    return tuple(out)


def place(tree, specs, dm):
    """The meta tree ``tree`` as DTensors on ``dm`` with ``specs``'
    placements, each holding device 0's (fake) shard; Python ints stay."""
    from torch.distributed.tensor import DTensor

    def rec(t, s):
        if isinstance(t, (list, tuple)) and not isinstance(s, P):
            return [rec(v, si) for v, si in zip(t, s)]
        if isinstance(t, dict):
            return {k: rec(v, s[k]) for k, v in t.items()}
        if not torch.is_tensor(t):
            return t
        pl = to_placements(s, dm)
        local = torch.empty(local_shape(t.shape, pl, dm), dtype=t.dtype)
        return DTensor.from_local(local, dm, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return rec(tree, specs)


def build_step_and_args(cfg, shape, mesh, dm, num_microbatches=N_MICRO,
                        dtype=torch.bfloat16, remat=True):
    """(step, args, info) of the reference's ``build_step_and_args``: the
    inputs placed on ``dm`` by the production rules."""
    kind, specs = input_specs(cfg, shape, dtype)
    info = {"kind": kind, "layout": "train"}
    if kind == "decode" and serve_mode_fits(specs["params"], specs["state"],
                                            mesh):
        info["layout"] = "serve"
    pspecs = param_specs(specs["params"], cfg, mesh, mode=info["layout"])
    params = place(specs["params"], pspecs, dm)
    batch = place(specs["batch"], batch_specs(specs["batch"], mesh), dm)
    if kind == "train":
        n_mb = min(num_microbatches, shape.global_batch)
        info["microbatches"] = n_mb
        opt = specs["opt_state"]
        ospecs = {"m": pspecs, "v": pspecs, "count": P()}
        opt = place(opt, ospecs, dm)
        step = build_train_step(cfg, AdamWConfig(), num_microbatches=n_mb,
                                remat=remat)
        return step, (params, opt, batch), info
    if kind == "prefill":
        return build_prefill_step(cfg), (params, batch), info
    state = place(specs["state"], decode_state_specs(specs["state"], cfg,
                                                      mesh), dm)
    return build_decode_step(cfg), (params, state, batch), info


def _out_bytes(out) -> int:
    from torch.distributed.tensor import DTensor
    seen, n = set(), 0

    def rec(t):
        nonlocal n
        if isinstance(t, (list, tuple)):
            for v in t:
                rec(v)
        elif isinstance(t, dict):
            for v in t.values():
                rec(v)
        elif torch.is_tensor(t):
            loc = t.to_local() if isinstance(t, DTensor) else t
            st = loc.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                n += st.nbytes()
    rec(out)
    return n


def moe_formulation(cfg, mesh, shape: InputShape, n_mb: int = 1):
    """What the MoE layers of ``cfg`` run on the dry run's DTensors at
    ``shape`` in ``n_mb`` microbatches (``models.moe.dtensor_formulation``),
    or None without MoE: the reference's formulation, or a stand-in for
    its capacity dispatch."""
    if cfg.moe is None:
        return None
    tokens = shape.global_batch // n_mb * (
        1 if shape.kind == "decode" else shape.seq_len)
    key = dtensor_formulation(mesh, cfg, tokens)
    return {"formulation": key, "tokens": tokens,
            "what": DTENSOR_FORMULATIONS[key]}


def report(costs: dict, gpu, mesh) -> dict:
    """The roofline terms and bottleneck of a :meth:`DeviceCounter.totals`
    on ``gpu`` over ``mesh``, with the link each axis is charged at."""
    links = axis_links(mesh, gpu)
    terms = roofline_terms(costs, gpu, links)
    return {"roofline_seconds": terms,
            "bottleneck": max(terms, key=terms.get),
            "links": {a: name for a, (name, _) in links.items()}}


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               gpu: str = "h100-sxm", mesh: LogicalMesh | None = None,
               cfg=None, shape: InputShape | None = None,
               num_microbatches: int = N_MICRO, dtype=torch.bfloat16,
               verbose: bool = True) -> dict:
    """One (arch x shape) on the production mesh (or ``mesh``), with the
    architecture's config (or ``cfg``) and the named input shape (or
    ``shape``) -> the report dict (the reference's keys, and a few)."""
    card = get_gpu(gpu)
    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "skipped": why}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    prev = policy.get_policy()
    policy.set_policy("ref")
    t0 = time.time()
    try:
        with production_mesh(mesh) as (dm, fm):
            step, args, info = build_step_and_args(
                cfg, shape, mesh, dm, num_microbatches, dtype)
            counter = DeviceCounter(axis_of_group(dm), fm)
            counter.track(args)
            with counter:
                out = step(*args)
                out_bytes = _out_bytes(out)
                del out, args, step
    finally:
        policy.set_policy(prev)
    wall = time.time() - t0
    costs = counter.totals()
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh.label(),
        "chips": mesh.size, "gpu": card.name, "layout": info["layout"],
        "run_s": round(wall, 2),
        "bytes_per_device": {
            "arguments": counter.arguments,
            "outputs": out_bytes,
            "temps": counter.peak - counter.arguments,
            "peak": counter.peak,
        },
        "per_device": costs,
        **report(costs, card, mesh),
        "note": PLAIN_ATTENTION_NOTE,
    }
    if "microbatches" in info:
        result["microbatches"] = info["microbatches"]
    moe = moe_formulation(cfg, mesh, shape, info.get("microbatches", 1))
    if moe is not None:
        result["moe"] = moe
    if verbose:
        b = result["bytes_per_device"]
        terms = result["roofline_seconds"]
        print(f"[{arch} x {shape.name} @ {result['mesh']} on {card.key}] "
              f"run {wall:.1f}s ({info['layout']} layout)")
        print(f"  memory/device: args {b['arguments'] / 2**30:.2f} GiB, "
              f"temps {b['temps'] / 2**30:.2f} GiB, peak "
              f"{b['peak'] / 2**30:.2f} GiB")
        print(f"  per-device flops {costs['flops']:.3e}, hbm "
              f"{costs['hbm_bytes']:.3e} B, collectives "
              f"{costs['collective_bytes']:.3e} B {costs['collectives']}")
        print("  roofline terms (s): "
              + ", ".join(f"{k}={v * 1e3:.2f}ms" for k, v in terms.items())
              + f" -> bottleneck: {result['bottleneck']} (links "
              + ", ".join(f"{a}: {n}" for a, n in result["links"].items())
              + ")")
        if moe is not None:
            print(f"  MoE: {moe['formulation']}, {moe['what']}")
    return result


def assigned_archs() -> list[str]:
    """The assigned architectures (the paper's own Llama models apart)."""
    return [get_config(a).name for a in ARCHS if not a.startswith("llama")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) combination")
    ap.add_argument("--json", default=None, help="append results to file")
    ap.add_argument("--gpu", required=True,
                    help="the card whose constants the roofline takes: a key "
                         "(h100-sxm) or the name torch.cuda.get_device_name() "
                         "gives")
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
    results = []
    for arch, shape in combos:
        try:
            results.append(dryrun_one(arch, shape, multi_pod=args.multi_pod,
                                      gpu=args.gpu))
        except Exception as e:  # noqa: BLE001 -- report and go on
            print(f"[{arch} x {shape}] FAILED: {type(e).__name__}: {e}")
            results.append({"arch": arch, "shape": shape,
                            "error": f"{type(e).__name__}: {e}"})
    if args.json:
        with open(args.json, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    failed = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(failed)}/{len(results)} combinations OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
