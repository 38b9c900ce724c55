"""A cell of ``BENCHMARK.json`` and every file it names, found by name."""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    config: str            # configuration name
    conf: dict             # configs/<config>.json
    traffic: dict          # traffic/<mix>.json
    limits: dict           # limits/<cell>.json
    chips: int
    end_to_end: list       # the spec's metric entries this cell reports
    per_layer: list

    def module(self, kind: str):
        """``port``, ``reference`` or ``flops`` of the configuration's
        model type."""
        return importlib.import_module(
            f"bench.{kind}.{self.conf['model_type']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, spec: dict | None = None,
              bench: Path = BENCH) -> Cell:
    spec = load_spec() if spec is None else spec
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(bench.parent / configs[w["config"]]["file"]) as f:
        conf = json.load(f)
    with open(bench / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(name=name, config=w["config"], conf=conf,
                traffic=traffic, limits=limits,
                chips=w["chips"],
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _reports(m, name)])
