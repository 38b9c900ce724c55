"""Data pipeline: synthetic corpora with realistic length distributions,
sequence packing, and the length-bucket machinery the mixed-length
scenarios (paper §7.3) need.  The port's copy of ``repro/data/pipeline.py``
(numpy only), unchanged.

Two synthetic corpora mirror the paper's evaluation sets:
  * ``commoncrawl`` — lognormal lengths, median ~600 tokens, heavy tail
    (97% of sequences under 8K at 32K context, matching Fig 16's remark);
  * ``github``      — flatter lognormal with a longer tail.

``pack_batch`` packs variable-length sequences into fixed context windows
with loss masks (the DeepSpeed/Megatron baseline treatment); bucketing +
per-step max-length stats feed HotSPa-style (Hetu-A) and heterogeneous
(Hetu-B) strategy selection.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CorpusConfig:
    name: str = "commoncrawl"
    vocab: int = 32000
    seed: int = 0
    max_len: int = 32768


_DISTS = {
    # (log-mean, log-std) of token counts
    "commoncrawl": (6.4, 1.1),    # median ~600, 97% < 8K
    "github": (7.0, 1.3),         # median ~1100, longer tail
}


class SyntheticCorpus:
    """Deterministic stream of (tokens, length) samples."""

    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg
        if cfg.name not in _DISTS:
            raise KeyError(f"unknown corpus {cfg.name!r}")
        self._rng = np.random.default_rng(cfg.seed)

    def sample_lengths(self, n: int) -> np.ndarray:
        mu, sigma = _DISTS[self.cfg.name]
        ln = self._rng.lognormal(mu, sigma, size=n)
        return np.clip(ln.astype(np.int64), 8, self.cfg.max_len)

    def sample_sequences(self, n: int) -> list[np.ndarray]:
        lens = self.sample_lengths(n)
        return [self._rng.integers(0, self.cfg.vocab, size=int(l),
                                   dtype=np.int32) for l in lens]


def pack_batch(seqs: list[np.ndarray], batch: int, context: int,
               pad_id: int = 0):
    """Greedy first-fit packing into (batch, context) windows.

    Returns dict(tokens, labels, loss_mask, positions) — positions reset
    at every packed-sequence boundary so RoPE does not leak across
    documents.  Sequences longer than ``context`` are truncated (the
    baseline systems' behaviour in §7.3)."""
    tokens = np.full((batch, context), pad_id, np.int32)
    positions = np.zeros((batch, context), np.int32)
    mask = np.zeros((batch, context), np.float32)
    row, col = 0, 0
    for seq in seqs:
        seq = seq[:context]
        while len(seq) and row < batch:
            space = context - col
            take = min(space, len(seq))
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


# ---------------------------------------------------------------------------
# mixed-length bucketing (paper §7.3)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Bucket:
    lo: int
    hi: int

    def holds(self, n: int) -> bool:
        return self.lo < n <= self.hi


DEFAULT_BUCKETS_32K = (Bucket(0, 4096), Bucket(4096, 16384),
                       Bucket(16384, 32768))
DEFAULT_BUCKETS_16K = (Bucket(0, 4096), Bucket(4096, 16384))


def bucketize(seqs: list[np.ndarray], buckets) -> dict[Bucket, list]:
    out = {b: [] for b in buckets}
    for s in seqs:
        for b in buckets:
            if b.holds(len(s)):
                out[b].append(s)
                break
        else:
            out[buckets[-1]].append(s[:buckets[-1].hi])
    return out


def step_stream(corpus: SyntheticCorpus, tokens_per_step: int,
                n_steps: int):
    """Yields per-step sequence lists totalling ~tokens_per_step tokens
    (the paper uses 200K tokens/step)."""
    for _ in range(n_steps):
        seqs: list[np.ndarray] = []
        total = 0
        while total < tokens_per_step:
            (s,) = corpus.sample_sequences(1)
            seqs.append(s)
            total += len(s)
        yield seqs
