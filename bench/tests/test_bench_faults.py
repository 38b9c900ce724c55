"""The check on a broken program: the whole run with the harness's look
for a chip skipped, on the CPU at reduced sizes, with each fault a
training cell on one chip can have planted underneath the timed path,
comes out not correct under the cells' limits.  (A cell on one chip has
no exchange between chips to leave out.)"""

import pytest

from bench import harness

from helpers import TINY, tiny_cell

SEED = 2**31 + 5003


@pytest.mark.parametrize("fault", harness.FAULTS)
@pytest.mark.parametrize("config", sorted(TINY))
def test_fault_is_caught(config, fault):
    cell = tiny_cell(config)
    res = harness.run(cell, SEED, 0.1, trace=False, device="cpu",
                      fault=fault)
    assert not res["correct"], res["check"]
