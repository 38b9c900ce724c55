"""Dispatch between the Hopper kernels and their plain versions.

The model layers call these functions, so :func:`policy.set_policy` moves
every hot spot between the kernels and the plain versions without touching
model code.  Only attention exists so far; the SSD and RG-LRU scans come
with the slices that port them.
"""

from __future__ import annotations

from .flash_attention import flash_attention
from .policy import select_attention_impl
from .ref import flash_attention_ref


def attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q: (B, H, Sq, D); k, v: (B, K, Sk, D)."""
    if select_attention_impl(q.shape, k.shape, q.device) == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
