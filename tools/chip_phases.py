#!/usr/bin/env python3
"""Run single phases of ``chip_smoke.py`` on one NVIDIA GPU, in one fresh
process, after building the kernels:

    python3 tools/chip_phases.py attention families

Phases, in the order given:

* ``attention``: phase 3's flash-attention cases (every head dim, MLA's
  q/k 192 with v 128, the edge cases), each against its plain version;
  the main ones timed against their bound and SDPA.
* ``ssd`` and ``rglru``: phase 3's SSD and RG-LRU scan cases.
* ``serve``: phase 4, Qwen2-1.5B, Mamba2-370M and RecurrentGemma-9B
  served at full width and depth in fp32, then prefilled in bf16.
* ``train``: phase 6, the production trainer on each of
  ``chip_smoke.TRAIN_ARCHS``.
* ``families``: phase 9, DeepSeek-V2, Grok-1, Qwen2-VL and Whisper
  served at published widths.
* ``famtrain``: phase 12, the same families trained through
  ``launch.train.main`` (``chip_smoke.FAMILY_TRAIN``).
* ``dist``: phase 10, ranks sharing the card: the rank selftest (comm
  and async cases at 2 ranks, comm, api, async and search cases at 4),
  then phase 5's program on 4 ranks under dp2 x tp2 and under the hsize=2
  dp2|tp2 strategy, against phase 5's run (which it runs first, as
  ``chip_smoke.py`` does), and phase 5's blocks under tp2 x pp2 as a
  4-rank pipeline on ``DistAsyncExecutor`` and ``DistExecutor``.
* ``ep``: phase 10 (e) alone: one DeepSeek-V2 MoE layer at published
  widths expert-parallel on 4 ranks sharing the card
  (``repro_torch.launch.moe_ep``), against rank 0's single-process
  dispatch and the dry run's all-reduce bytes for that layer.
* ``dryrun``: phase 11: the dry-run child (rooflines, full dry runs, the
  anchors' predictions) beside phase 6's Qwen2-1.5B run and phase 12,
  which give the anchors' measured sides.

Each phase prints what it prints in ``chip_smoke.py`` and then one line
``<phase>: {json}``.  A phase that fails exits non-zero, as in
``chip_smoke.py``.  Needs a visible CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("attention", "ssd", "rglru", "serve", "train", "families",
          "famtrain", "dist", "ep", "dryrun")


def ep_layer(torch, cs):
    """The dry run's collective bytes of phase 10 (e)'s MoE layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.launch.roofline import moe_component
    return moe_component(get_config(cs.EP_ARCH),
                         LogicalMesh(("data", "model"), cs.EP_MESH),
                         cs.EP_TOKENS, torch.float32)


def dist(torch, cs, fa, ref):
    """Phase 5's run, its state after step ``DIST_STEPS`` written for the
    ranks, then phase 10."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="phase5-sim-") as d:
        _, ir_run = cs.phase_graph_ir(torch, fa, ref,
                                      cs.SimulatorReference(d))
    with tempfile.TemporaryDirectory(prefix="phase5-") as d:
        ref_state = cs.dist_reference(ir_run, d)
        losses = ir_run["losses"][:cs.DIST_STEPS]
        del ir_run
        return cs.phase_dist(torch, fa, ref, ref_state, losses,
                             ep_layer(torch, cs))


def ep(torch, cs):
    """Phase 10 (e) in a launch of its own."""
    from repro_torch.runtime.harness import run_ranks
    layer = ep_layer(torch, cs)
    procs = run_ranks("repro_torch.launch.moe_ep",
                      cs.EP_MESH[0] * cs.EP_MESH[1], backend="gloo",
                      device="cuda", timeout=cs.DIST_SWEEP_TIMEOUT,
                      extra_args=["--arch", cs.EP_ARCH, "--tokens",
                                  str(cs.EP_TOKENS), "--data",
                                  str(cs.EP_MESH[0]), "--model",
                                  str(cs.EP_MESH[1])])
    e = cs.rank_reports(procs[:1], "MOE_EP_JSON")[0]
    return {"e": cs.check_ep([{"e": e}], layer)}


def dryrun(torch, cs, policy, kernels, stage):
    """Phase 11 with phase 6's first config and phase 12 as the anchors'
    measured sides."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="phase11-") as d:
        child = cs.DryRunChild(d, cs.gpu_name_from_smi())
        train = cs.phase_train_all(torch, policy, kernels, stage,
                                   cs.TRAIN_ARCHS[:1])
        famtrain, _ = cs.phase_families_train(torch, policy, kernels, stage)
        out = cs.phase_production_dryrun(child, train, famtrain)
    out.pop("roofline")
    return out


def main(argv) -> int:
    names = argv or ["attention", "families"]
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        print(f"unknown phases {unknown}; choose from {PHASES}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a "
                "GPU")
    from repro_torch.kernels import _build, policy, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rk
    from repro_torch.kernels import ssd_scan as sk

    print(cs.card_line())
    reports = _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = {"flash": fa, "ssd": sk, "rglru": rk}
    stages = []

    def stage(**configs):
        """A host stage for phase 6 or 12, freed after the phase."""
        stages.append(cs.training_stage(torch, **configs))
        return stages[-1]
    runs = {
        "attention": lambda: cs.phase_attention(torch, fa, ref, gen),
        "ssd": lambda: cs.phase_ssd(
            torch, sk, ref, gen,
            cs.ptxas_report(reports.get("ssd_scan", ""))),
        "rglru": lambda: cs.phase_rglru(torch, rk, ref, gen),
        "serve": lambda: {arch: cs.phase_serve(torch, policy, arch)
                          for arch in cs.ARCHS},
        "train": lambda: cs.phase_train_all(torch, policy, kernels,
                                            stage(families=())),
        "families": lambda: cs.phase_families(torch, policy, fa, ref),
        "famtrain": lambda: cs.phase_families_train(torch, policy, kernels,
                                                    stage(archs=())),
        "dist": lambda: dist(torch, cs, fa, ref),
        "ep": lambda: ep(torch, cs),
        "dryrun": lambda: dryrun(torch, cs, policy, kernels, stage()),
    }
    for name in names:
        t0 = time.perf_counter()
        out = runs[name]()
        while stages:
            stages.pop().close()
        if name == "families":
            fams, b1, _ = out
            out = {"runs": fams, "b1": b1}
        elif name == "serve":
            out = {arch: {"launches": run[0], "bf16": run[1]}
                   for arch, run in out.items()}
        elif name == "train":
            out = {"runs": out}
        elif name == "famtrain":
            out = {"runs": out[0]}
        elif name == "dist":
            b1, ranks = out
            out = {"ranks": ranks, "b1": b1}
        elif name in ("ep", "dryrun"):
            pass
        else:
            worst, timing = out
            out = {"max_abs_err": worst,
                   "timing": {str(k): v for k, v in timing.items()}}
        out["phase_s"] = time.perf_counter() - t0
        print(f"{name}: {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
