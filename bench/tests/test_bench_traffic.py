"""The traffic generator: deterministic in the seed, rows that differ,
positions that restart at each document."""

import numpy as np
import pytest

from bench.cell import load_cell
from bench.generator import half_batch, make_batches, pack_batch

SEED = 2**31 + 977


@pytest.mark.parametrize("cell", ["qwen2-1.5b.pack4k",
                                  "qwen2-1.5b.pack512"])
def test_deterministic_in_seed(cell):
    c = load_cell(cell)
    traffic = {**c.traffic, "pool_steps": 4}
    a = make_batches(traffic, c.conf["vocab_size"], SEED)
    b = make_batches(traffic, c.conf["vocab_size"], SEED)
    other = make_batches(traffic, c.conf["vocab_size"], SEED + 1)
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["tokens"], other[0]["tokens"])
    rows = np.concatenate([x["tokens"] for x in a])
    assert len({r.tobytes() for r in rows}) == len(rows)
    assert rows.shape[1] == traffic["context"]
    assert rows.max() < c.conf["vocab_size"]
    assert all(x["loss_mask"].all() for x in a)   # rows filled whole


def test_pack_batch_positions_and_labels():
    docs = [np.arange(1, 4, dtype=np.int32), np.arange(10, 16,
                                                       dtype=np.int32)]
    b = pack_batch(docs, 2, 4)
    # a document is clipped to the context, then continues on the next row
    np.testing.assert_array_equal(b["tokens"], [[1, 2, 3, 10],
                                                [11, 12, 13, 0]])
    np.testing.assert_array_equal(b["positions"], [[0, 1, 2, 0],
                                                   [0, 1, 2, 0]])
    np.testing.assert_array_equal(b["labels"], [[2, 3, 10, 0],
                                                [12, 13, 0, 0]])
    np.testing.assert_array_equal(b["loss_mask"], [[1, 1, 1, 1],
                                                   [1, 1, 1, 0]])
    assert half_batch(b)["tokens"].shape == (1, 4)
