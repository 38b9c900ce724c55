"""Training traffic: packed batches drawn from ``--seed``.

A copy of the program's synthetic corpus and packer
(``src/repro_torch/data/pipeline.py``: ``SyntheticCorpus`` with its
lognormal document lengths, ``pack_batch``), kept here so that a change to
the program cannot move the yardstick.  A traffic file
(``traffic/<mix>.json``) gives the parameters:

* ``log_mean``, ``log_std``: the lognormal of document lengths in tokens
  (``commoncrawl``: 6.4 and 1.1, median ~600);
* ``min_len``: the shortest document; ``context``: the row length, which
  also clips each document;
* ``rows``: rows a step; ``microbatches``: how many microbatches a step
  cuts them into;
* ``checked_steps``: the steps the correctness check follows;
* ``pool_steps``: batches made in set-up, fed in turn (then from the
  start again).

Every step's rows are filled from fresh documents, so no two rows of the
pool are alike.  Token ids are drawn over the model's vocabulary.
"""

from __future__ import annotations

import numpy as np

KEYS = ("log_mean", "log_std", "min_len", "context", "rows",
        "microbatches", "checked_steps", "pool_steps")


def check_traffic(traffic: dict) -> None:
    """Raise on a traffic file that misses a key or cannot be cut."""
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise KeyError(f"traffic file lacks {missing}")
    if traffic["rows"] % traffic["microbatches"]:
        raise ValueError("rows must be a multiple of microbatches")
    if traffic["pool_steps"] < traffic["checked_steps"]:
        raise ValueError("pool_steps must cover the checked steps")


def sample_documents(rng, traffic: dict, vocab: int, tokens: int):
    """Documents of lognormal length, clipped to ``[min_len, context]``,
    until they hold at least ``tokens`` tokens."""
    docs, total = [], 0
    while total < tokens:
        n = int(np.clip(int(rng.lognormal(traffic["log_mean"],
                                          traffic["log_std"])),
                        traffic["min_len"], traffic["context"]))
        docs.append(rng.integers(0, vocab, size=n, dtype=np.int32))
        total += n
    return docs


def pack_batch(seqs, batch: int, context: int, pad_id: int = 0) -> dict:
    """Greedy packing into (batch, context) rows: each document continues
    on the next row where the row is full, positions restart at every
    document (and at a row's start), labels are the next token."""
    tokens = np.full((batch, context), pad_id, np.int32)
    positions = np.zeros((batch, context), np.int32)
    mask = np.zeros((batch, context), np.float32)
    row, col = 0, 0
    for seq in seqs:
        seq = seq[:context]
        while len(seq) and row < batch:
            take = min(context - col, len(seq))
            tokens[row, col:col + take] = seq[:take]
            positions[row, col:col + take] = np.arange(take)
            mask[row, col:col + take] = 1.0
            col += take
            seq = seq[take:]
            if col >= context:
                row, col = row + 1, 0
        if row >= batch:
            break
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = pad_id
    return {"tokens": tokens, "labels": labels, "loss_mask": mask,
            "positions": positions}


def make_batches(traffic: dict, vocab: int, seed: int) -> list[dict]:
    """``pool_steps`` packed batches of numpy arrays, from ``seed``."""
    check_traffic(traffic)
    rng = np.random.default_rng(seed)
    rows, ctx = traffic["rows"], traffic["context"]
    return [pack_batch(sample_documents(rng, traffic, vocab, rows * ctx),
                       rows, ctx)
            for _ in range(traffic["pool_steps"])]


def half_batch(batch: dict) -> dict:
    """The first half of a batch's rows (a fault: the rest left out)."""
    n = next(iter(batch.values())).shape[0]
    return {k: v[: max(n // 2, 1)] for k, v in batch.items()}
