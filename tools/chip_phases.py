#!/usr/bin/env python3
"""Run single phases of ``chip_smoke.py`` on one NVIDIA GPU, in one fresh
process, after building the kernels:

    python3 tools/chip_phases.py attention families

Phases, in the order given:

* ``attention``: phase 3's flash-attention cases (every head dim, MLA's
  q/k 192 with v 128, the edge cases), each against its plain version;
  the main ones timed against their bound and SDPA.
* ``ssd`` and ``rglru``: phase 3's SSD and RG-LRU scan cases.
* ``families``: phase 9, DeepSeek-V2, Grok-1, Qwen2-VL and Whisper
  served at published widths.
* ``dist``: phase 10, ranks sharing the card: the rank selftest's comm
  sweep, then phase 5's program on 4 ranks against phase 5's run (which
  it runs first, as ``chip_smoke.py`` does).

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
PHASES = ("attention", "ssd", "rglru", "families", "dist")


def dist(torch, cs, fa, ref):
    """Phase 5's run, its final state written for the ranks, then phase
    10."""
    import tempfile
    _, ir_run = cs.phase_graph_ir(torch, fa, ref)
    with tempfile.TemporaryDirectory(prefix="phase5-") as d:
        ref_state = cs.dist_reference(ir_run, d)
        losses = ir_run["losses"]
        del ir_run
        return cs.phase_dist(torch, fa, ref, ref_state, losses)


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
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = {
        "attention": lambda: cs.phase_attention(torch, fa, ref, gen),
        "ssd": lambda: cs.phase_ssd(torch, sk, ref, gen),
        "rglru": lambda: cs.phase_rglru(torch, rk, ref, gen),
        "families": lambda: cs.phase_families(torch, policy, fa, ref),
        "dist": lambda: dist(torch, cs, fa, ref),
    }
    for name in names:
        t0 = time.perf_counter()
        out = runs[name]()
        if name == "families":
            fams, b1, _ = out
            out = {"runs": fams, "b1": b1}
        elif name == "dist":
            b1, ranks = out
            out = {"ranks": ranks, "b1": b1}
        else:
            worst, timing = out
            out = {"max_abs_err": worst,
                   "timing": {str(k): v for k, v in timing.items()}}
        out["phase_s"] = time.perf_counter() - t0
        print(f"{name}: {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
