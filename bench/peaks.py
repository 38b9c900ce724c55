"""Published peaks of the card (NVIDIA's H100 SXM data sheet, dense rates
at the 700 W limit), and the roofline bound of a call."""

from __future__ import annotations

from functools import lru_cache

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
              "float16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """Least time on the card: the larger of the operations at the peak
    rate of ``dtype`` and the bytes at the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def attention_bound_s(q_shape, k_shape, v_shape, causal: bool,
                      window, dtype: str) -> float:
    """An attention call's bound: the visible (query, key) pairs' 2 * D
    operations of q k^T and 2 * Dv of p v, against q, k, v and the output
    moved once (copied from ``chip_smoke.py:attention_bound_ms``, with the
    visible pairs counted in closed form)."""
    b, h, sq, d = q_shape
    sk = k_shape[2]
    dv = v_shape[3]
    pairs = visible_pairs(sq, sk, causal, window)
    flops = 2.0 * b * h * (d + dv) * pairs
    elt = 2 if dtype in ("bfloat16", "float16") else 4
    nbytes = elt * (_numel(q_shape) + _numel(k_shape) + _numel(v_shape)
                    + b * h * sq * dv)
    return bound_s(flops, nbytes, dtype)


@lru_cache(maxsize=None)
def visible_pairs(sq: int, sk: int, causal: bool, window=None) -> int:
    """(i, j) with j <= i when causal and j > i - window with a window,
    for queries i < sq and keys j < sk, each query aligned to the same
    key index."""
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(i - window + 1, 0) if window is not None else 0
        total += max(hi - lo + 1, 0)
    return total


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
