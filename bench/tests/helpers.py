"""Tiny cells for the CPU tests: the benchmark's model types at small
widths, under the test traffic ``data/traffic/tiny.json``."""

import json
from pathlib import Path

from bench.cell import Cell, load_cell, load_spec

DATA = Path(__file__).resolve().parent / "data"
#: each tiny configuration and the cell whose limits it is held to
TINY = {"qwen2-tiny": "qwen2-1.5b.pack4k"}


def tiny_cell(config: str) -> Cell:
    with open(DATA / "configs" / f"{config}.json") as f:
        conf = json.load(f)
    with open(DATA / "traffic" / "tiny.json") as f:
        traffic = json.load(f)
    full = load_cell(TINY[config])
    spec = load_spec()
    return Cell(name=f"{config}.tiny", config=config, conf=conf,
                traffic=traffic, limits=full.limits,
                chips=1, end_to_end=spec["end_to_end"],
                per_layer=spec["per_layer"])
