"""The readings that set a cell's limits from above: the reference put in
the program's place and run in the nearest precision below the
configuration's (fp32 with TF32 matmuls), and with each fault planted,
against the sound reference, on the cell's own weights and batches.

  python3 bench/control.py --workload qwen2-1.5b.pack512 --seeds 1,2,3

Prints one JSON line a seed: each variant's numbers.  A state left
unchanged reads 1 on ``grad_gap`` and ``change_gap`` and needs no run.
The benchmark's own runs do not run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("tf32", "half_batch", "altered")


def readings_for(cell, seed, variant, device):
    import torch

    from bench import generator
    from bench.harness import reference_readings

    pool = generator.make_batches(
        {**cell.traffic, "pool_steps": cell.traffic["checked_steps"]},
        cell.conf["vocab_size"], seed)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in pool]
    tf32 = variant == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return reference_readings(cell, seed, batches, device,
                                  fault=None if variant in (None, "tf32")
                                  else variant)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import check
    from bench.cell import load_cell
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        sound = readings_for(cell, seed, None, args.device)
        line = {"seed": seed, "sound_losses": sound.losses}
        for v in args.variants.split(","):
            found = check.gaps(readings_for(cell, seed, v, args.device),
                               sound)
            line[v] = {k: val for k, (val, _) in found.items()}
            line[v + "_at"] = {k: at for k, (_, at) in found.items()}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
