"""The control on the card: the reference put in the program's place with
TF32 matmuls (the nearest precision below the configurations' fp32)
against the sound reference comes out not correct under each cell's
limits, at the cell's own size (the reference alone: up to 71 GB and
14-19 s a run), on three seeds; and each fault planted in the reference does too,
at reduced sizes.  The same readings a cell at a time, with their
numbers: ``bench/control.py``."""

import pytest

from bench import check
from bench.cell import load_cell, load_spec

from helpers import TINY, tiny_cell

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
CELLS = [w["name"] for w in load_spec()["workloads"]]


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 exists only there)")
    return "cuda"


def fails(cell, variant, device):
    from bench.control import readings_for
    for seed in SEEDS:
        sound = readings_for(cell, seed, None, device)
        other = readings_for(cell, seed, variant, device)
        correct, numbers = check.judge(check.gaps(other, sound),
                                       cell.limits)
        assert not correct, (seed, numbers)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(cuda, name):
    fails(load_cell(name), "tf32", cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["half_batch", "altered"])
@pytest.mark.parametrize("config", sorted(TINY))
def test_fault_fails(cuda, config, variant):
    fails(tiny_cell(config), variant, cuda)
