"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric resolves to its files by name, within the
contract's limits."""

import json
import re

import pytest

from bench import check
from bench.cell import BENCH, ROOT, load_cell, load_spec
from bench.generator import check_traffic
from bench.metrics import reader

SPEC = load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200
    cell = load_cell(w["name"])
    check_traffic(cell.traffic)
    for kind in ("port", "reference", "flops"):
        assert cell.module(kind) is not None
    # every number compared has its limit
    assert all(cell.limits[n] > 0 for n in check.NUMBERS)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(c):
    assert NAME.match(c["name"])
    assert c["file"].startswith("bench/configs/")
    with open(ROOT / c["file"]) as f:
        conf = json.load(f)
    assert conf.get("reduced", []) == c["reduced"]
    assert len(c["reduced"]) <= 16
    # no width: a hidden, intermediate, latent, state, projection or head
    # size, an expansion factor, the experts a token takes
    widths = re.compile(r"(hidden_size|intermediate|latent|state|_dim$|"
                        r"_rank$|head|expan|experts_per_tok)")
    assert not any(widths.search(k) for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    assert callable(reader(m["name"]))
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]}


def test_every_file_is_named_by_a_name():
    names = re.compile(r"^[A-Za-z0-9_./-]+$")
    for path in BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert names.match(str(path.relative_to(ROOT))), path
