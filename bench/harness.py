"""One run of a cell: set-up, the timed window, the trace, the check.

Set-up builds the production trainer's step once (``build_train_step``
with its model and AdamW state, under ``use_mesh(make_smoke_mesh())``, as
``repro_torch.launch.train`` runs it), drives it from the seed through the
traffic's checked steps, reads what the check needs, and hands the same
step, parameters and state to the window.  The window runs whole steps,
one after another, each fed its batch from pinned host memory, until
``seconds`` have passed; the step in flight then completes and counts.
With ``trace`` the window runs as without, and ``torch.profiler`` then
records one more step, after a step that warms it up: the per-layer
metrics read that step, and ``mfu`` the window.  Once the window
has closed and the program's state is freed, the plain reference follows
the checked steps from the same weights and batches, and the two are
compared (:mod:`bench.check`)."""

from __future__ import annotations

import contextlib
import gc
import math
import subprocess
import sys
import time

from . import check, generator
from .cell import ROOT, Cell
from .flops import step_flops
from .metrics import Context, reader
from .peaks import PEAK_FLOPS
from .reference import common
from .weights import make_weights

#: top-level module names that no run may hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: faults a test can plant in the program's step (see ``planted``)
FAULTS = ("stale", "half_batch", "altered")
#: the altered loss's relative change
ALTERED = 1e-3
#: with --trace 1: steps run under the profiler after the window, to warm
#: it up and then recorded
PROFILED = (1, 1)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not hold,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def _norms(tree) -> dict:
    import torch
    with torch.no_grad():
        return {common.path_name(p): float(torch.linalg.vector_norm(t))
            for p, t in common.tree_paths(tree)}


def _changes(tree, start) -> dict:
    import torch
    before = dict(common.tree_paths(start))
    with torch.no_grad():
        return {common.path_name(p): float(torch.linalg.vector_norm(
            t - before[p])) for p, t in common.tree_paths(tree)}


@contextlib.contextmanager
def planted(fault, step_fn, cfg, microbatches, remat):
    """The program's step with ``fault`` planted underneath: ``stale``
    returns the state unchanged; ``half_batch`` leaves half of each
    batch's rows out (the mean taken over the rest); ``altered`` alters
    the loss where the model produces it."""
    if fault is None:
        yield step_fn
        return
    from repro_torch.train import steps
    if fault == "stale":
        def stale(params, opt_state, batch):
            loss, _ = steps.accumulate_grads(params, batch, cfg,
                                             microbatches, remat)
            return params, opt_state, {"loss": loss}
        yield stale
    elif fault == "half_batch":
        yield lambda p, o, b: step_fn(p, o, generator.half_batch(b))
    elif fault == "altered":
        real = steps.loss_fn

        def altered(*a, **k):
            loss, aux = real(*a, **k)
            return loss * (1 + ALTERED), aux
        steps.loss_fn = altered
        try:
            yield step_fn
        finally:
            steps.loss_fn = real
    else:
        raise ValueError(f"unknown fault {fault!r}; faults: {FAULTS}")


@contextlib.contextmanager
def attention_spans(calls: list):
    """Wrap the model's attention entry (``kernels.ops.attention``) in a
    ``bench.attention_forward`` range and record each call's shapes."""
    import torch
    from repro_torch.kernels import ops
    real = ops.attention

    def attention(q, k, v, *, causal=True, window=None):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      causal, window, str(q.dtype).removeprefix("torch.")))
        with torch.profiler.record_function("bench.attention_forward"):
            return real(q, k, v, causal=causal, window=window)
    ops.attention = attention
    try:
        yield
    finally:
        ops.attention = real


def reference_readings(cell: Cell, seed: int, batches, device,
                       fault=None) -> check.Readings:
    """The plain reference over the checked steps, from the seed's
    weights; ``fault`` (``half_batch``, ``altered``, ``stale``) plants one
    in the reference when it stands in the program's place."""
    conf, tr = cell.conf, cell.conf["training"]
    ref = cell.module("reference")
    shapes = ref.param_shapes(conf)
    mb = cell.traffic["microbatches"]
    if fault == "half_batch":
        batches = [generator.half_batch(b) for b in batches]
        if next(iter(batches[0].values())).shape[0] % mb:
            mb = 1
    params = make_weights(shapes, seed, device, tr["init_std"])
    losses, grads = common.train(
        lambda p, b: ref.loss(p, b, conf, remat=tr["remat"]), params,
        batches, mb, tr["adamw"],
        loss_scale=1 + ALTERED if fault == "altered" else 1.0,
        update=fault != "stale")
    start = make_weights(shapes, seed, device, tr["init_std"])
    changes = _changes(params, start)
    return check.Readings(losses, grads, changes)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        fault=None, t_start=None) -> dict:
    """One run -> the result line's fields, and ``stderr``: the numbers
    compared, beside their limits, for the run's last lines there."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.sharding.hints import use_mesh
    from repro_torch.train.steps import build_train_step

    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    device = torch.device(device)
    cuda = device.type == "cuda"
    conf, traffic = cell.conf, cell.traffic
    tr = conf["training"]
    torch.backends.cuda.matmul.allow_tf32 = bool(tr["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(tr["tf32"])

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # the traffic, made on the host, and the weights, on the device
    pool = [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in generator.make_batches(traffic, conf["vocab_size"],
                                            seed)]
    if cuda:
        pool = [{k: v.pin_memory() for k, v in b.items()} for b in pool]
    marks.append(("traffic", time.perf_counter()))
    shapes = cell.module("reference").param_shapes(conf)
    params = make_weights(shapes, seed, device, tr["init_std"])
    cfg = cell.module("port").model_config(cell.config, conf)
    opt = AdamWConfig(**tr["adamw"])
    opt_state = init_opt_state(params)
    mb = traffic["microbatches"]
    step_fn = build_train_step(cfg, opt, num_microbatches=mb,
                               remat=tr["remat"])
    mesh = make_smoke_mesh()

    def feed(i):
        return {k: v.to(device, non_blocking=True)
                for k, v in pool[i % len(pool)].items()}

    losses = []
    marks.append(("weights", time.perf_counter()))
    with planted(fault, step_fn, cfg, mb, tr["remat"]) as step:
        # set-up: the checked steps, through the window's own call and feed
        checked = traffic["checked_steps"]
        prog_losses, prog_grads = [], None
        for i in range(checked):
            with use_mesh(mesh):
                params, opt_state, met = step(params, opt_state, feed(i))
            prog_losses.append(float(met["loss"]))
            if i == 0:
                prog_grads = {n: g / (1 - opt.b1) for n, g in
                              _norms(opt_state["m"]).items()}
        marks.append(("checked steps", time.perf_counter()))
        start = make_weights(shapes, seed, device, tr["init_std"])
        prog = check.Readings(prog_losses, prog_grads,
                              _changes(params, start))
        del start
        sync()
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)

        # the window, unprofiled
        i, n = checked, 0
        rf = torch.profiler.record_function

        def timed_step():
            nonlocal params, opt_state, i
            with rf("bench.step"):
                with rf("bench.feed"):
                    batch = feed(i)
                with use_mesh(mesh):
                    params, opt_state, met = step(params, opt_state, batch)
                sync()
            losses.append(met["loss"].detach())
            i += 1

        sync()
        t0 = time.perf_counter()
        while True:
            timed_step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

        # with --trace 1, after the window: one step to warm the profiler
        # up, then one recorded step
        calls: list = []
        prof = None
        if trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        schedule)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts, schedule=schedule(
                wait=0, warmup=PROFILED[0], active=PROFILED[1], repeat=1))
            with attention_spans(calls):
                prof.start()
                for k in range(sum(PROFILED)):
                    if k == PROFILED[0]:
                        calls.clear()    # the recorded steps' calls only
                    timed_step()
                    prof.step()
                prof.stop()
    run_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window_losses = torch.stack(losses).cpu().numpy()
    failed = int(np.sum(~np.isfinite(window_losses))) + sum(
        not math.isfinite(x) for x in prog_losses)

    ctx = Context(setup_s=t0 - t_start, window_s=t1 - t0, steps=n,
                  tokens_per_step=traffic["rows"] * traffic["context"],
                  flops_per_step=step_flops(conf, traffic),
                  peak_flops=PEAK_FLOPS[tr["dtype"]],
                  window_peak_bytes=window_peak, attention_calls=calls)
    result = {"correct": False, "attempted": i, "failed": failed}
    marks.append(("readings", t0))
    at = t_start
    for name, t in marks:
        print(f"set-up: {name} {t - at:.3f} s", file=sys.stderr)
        at = t
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu",
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": max(setup_peak, run_peak)}
    if trace:
        from . import trace as tracing
        path = ROOT / "bench_runs" / f"{cell.name}.{seed}.trace.json"
        path.parent.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(path))
        del prof
        ctx.trace = tracing.load(path)
        win = ctx.trace.window("bench.step")
        if win is not None:
            ctx.trace_window = win
            lo, hi, _ = win
            tid = next(h[3] for h in ctx.trace.host if h[2] == "bench.step")
            device_info["busy_s"] = tracing.busy_us(ctx.trace, lo, hi) / 1e6
            device_info["window_s"] = (hi - lo) / 1e6
            result["breakdown"] = tracing.breakdown(ctx.trace, lo, hi, tid)
        metrics = cell.per_layer
    else:
        metrics = cell.end_to_end
    values = {}
    for m in metrics if cuda else ():    # no device metric from a CPU run
        v = reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = values
    result["device"] = device_info
    if cuda:
        result["card"] = card_line()

    # the check, on the program's state freed
    del params, opt_state, met, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    batches = [{k: v.to(device) for k, v in pool[i].items()}
               for i in range(checked)]
    ref = reference_readings(cell, seed, batches, device)
    result["reference_s"] = time.perf_counter() - t_ref
    correct, numbers = check.judge(check.gaps(prog, ref), cell.limits)
    result["correct"] = correct and failed == 0
    result["readings"] = {"program_losses": prog.losses,
                          "reference_losses": ref.losses,
                          "left_out_of_change": check.left_out(ref)}
    result["check"] = {k: {"value": v["value"]
                           if math.isfinite(v["value"]) else None,
                           "limit": v["limit"], "at": v["at"]}
                       for k, v in numbers.items()}
    return result
