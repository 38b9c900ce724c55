"""Plain PyTorch versions of the port's kernels (the allclose references).

Each follows its JAX oracle in ``repro.kernels.ref`` cast for cast.  The
SSD-scan and RG-LRU oracles come with the slice that ports those kernels.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, K, Sk, D) with H % K == 0 (GQA).

    Logits are formed in ``q.dtype`` and then taken to fp32, the softmax is
    fp32, and the probabilities are cast back to ``q.dtype``.  Masked logits
    are the finite -1e30, so a row with no visible key averages v over all
    keys, as in the Pallas kernel."""
    b, h, sq, d = q.shape
    rep = h // k.shape[1]
    kq = k.repeat_interleave(rep, dim=1)
    vq = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kq).float()
    logits = logits / math.sqrt(d)
    sk = k.shape[2]
    qi = torch.arange(sq, device=q.device)
    ki = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki[None, :] <= qi[:, None]
    if window is not None:
        mask &= ki[None, :] > qi[:, None] - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vq)
