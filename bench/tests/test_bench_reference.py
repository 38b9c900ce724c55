"""The reference against the port's production step at reduced sizes on
the CPU: the harness's whole run, kernels replaced by their plain
versions, comes out correct under the cells' limits; and the weight tree
the benchmark makes is the one the port's ``init_params`` lays out."""

import pytest
import torch

from bench import harness
from bench.reference.common import tree_paths
from bench.weights import make_weights

from helpers import TINY, tiny_cell

SEED = 2**31 + 4099


@pytest.mark.parametrize("config", sorted(TINY))
def test_weight_tree_is_the_ports(config):
    from repro_torch.models.model import init_params
    cell = tiny_cell(config)
    cfg = cell.module("port").model_config(config, cell.conf)
    port = init_params(cfg, device="meta",
                       generator=torch.Generator(device="cpu"))
    ours = make_weights(cell.module("reference").param_shapes(cell.conf),
                        SEED, "cpu", 0.02)
    assert [(p, tuple(t.shape)) for p, t in tree_paths(port)] == \
        [(p, tuple(t.shape)) for p, t in tree_paths(ours)]


@pytest.mark.parametrize("config", sorted(TINY))
def test_reference_agrees_with_the_port(config):
    # at these widths a leaf's rounding weighs more than at the cells'
    # (Qwen2's key bias, turned by RoPE, moves by 4e-6 of its change), so
    # the test holds every number to 1e-5 rather than to a cell's limits
    cell = tiny_cell(config)
    res = harness.run(cell, SEED, 0.2, trace=False, device="cpu")
    assert res["failed"] == 0 and res["attempted"] > 3
    for c in res["check"].values():
        assert c["value"] < 1e-5, res["check"]


def test_weights_deterministic_in_seed():
    shapes = {"a": ((3, 4), "normal"), "b": {"w": ((4,), "ones")}}
    x = make_weights(shapes, SEED, "cpu", 0.02)
    y = make_weights(shapes, SEED, "cpu", 0.02)
    assert torch.equal(x["a"], y["a"]) and torch.equal(x["b"]["w"],
                                                       torch.ones(4))


def test_traced_run_records_one_step_after_the_window():
    # the profiler records one step after the window and its warm-up
    # step; the check still holds
    cell = tiny_cell("qwen2-tiny")
    res = harness.run(cell, SEED + 1, 0.1, trace=True, device="cpu")
    assert res["failed"] == 0
    assert res["attempted"] >= cell.traffic["checked_steps"] + 1 + \
        sum(harness.PROFILED)
    assert 0 < res["device"]["window_s"] < 60
    assert res["breakdown"]["idle_gaps"]
    for c in res["check"].values():
        assert c["value"] < 1e-5, res["check"]
