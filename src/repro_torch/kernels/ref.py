"""Plain PyTorch versions of the port's kernels (the allclose references).

Each follows its JAX oracle in ``repro.kernels.ref`` cast for cast: where
JAX promotes a bf16 operand against an fp32 one, the cast is written out,
because ``torch.einsum`` takes one dtype.  The model's own plain paths
(``models/ssm.py``, ``models/rglru.py``) import the SSD and RG-LRU
versions from here, so there is one copy of each.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30

#: the RG-LRU gate constant c of a = exp(-c softplus(lam) r)
RGLRU_C = 8.0


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


def ssd_scan_ref(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan: ``repro/models/ssm.py:ssd_chunked``.

    x: (b, s, h, p) head inputs; dt: (b, s, h) softplus-ed step sizes;
    A: (h,) negative decay rates; B, C: (b, s, n), one group shared by the
    heads.  Returns (y (b, s, h, p) in x.dtype, final state (b, h, p, n)
    fp32).  The intra-chunk part is the einsum form; the inter-chunk
    recurrence is a Python loop over chunks.  A sequence that is not a
    multiple of ``chunk`` is padded with dt = 0, which leaves the state
    alone (decay exp(0) = 1, input dt x = 0).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        y, st = ssd_scan_ref(x, dt, A, B, C, chunk)
        return y[:, :s], st
    nc = s // chunk
    # JAX promotes bf16 against fp32 to fp32; written out here
    wide = torch.promote_types(x.dtype, dt.dtype)

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    la = dtc * A[None, None, None, :]                      # (b,nc,q,h)
    cum = torch.cumsum(la, dim=2)
    total = cum[:, :, -1]                                  # (b,nc,h)
    xbar = xc.to(wide) * dtc[..., None].to(wide)

    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,q,q,h)
    qi = torch.arange(chunk, device=x.device)
    causal = (qi[:, None] >= qi[None, :])[None, None, :, :, None]
    # masked before the exp: above the diagonal diff is a sum of -dt A > 0
    # that overflows exp at a full chunk, and where(causal, exp(diff), 0)
    # would back-propagate 0 * inf = NaN into it.  The values are the same.
    L = torch.exp(torch.where(causal, diff, -torch.inf))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)       # in B's dtype
    sw = torch.promote_types(scores.dtype, L.dtype)
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores.to(sw),
                           L.to(sw), xbar.to(sw))

    decay_to_end = torch.exp(total[:, :, None, :] - cum)   # (b,nc,q,h)
    bw = torch.promote_types(Bc.dtype, decay_to_end.dtype)
    S_chunk = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc.to(bw),
                           decay_to_end.to(bw), xbar.to(bw))

    S = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * torch.exp(total[:, c])[:, :, None, None] + S_chunk[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)                  # (b,nc,h,p,n)

    decay_in = torch.exp(cum)
    cw = torch.promote_types(Cc.dtype, S_prevs.dtype)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc.to(cw),
                           decay_in.to(cw), S_prevs.to(cw))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), S


def rglru_coefficients(x, r, i, lam):
    """The RG-LRU recurrence's a and b terms in fp32, as
    ``repro/kernels/rglru_scan.py:rglru_pallas`` forms them:
    a = exp(-c softplus(lam) r), b = sqrt(max(1 - a^2, 1e-12)) (i x)."""
    log_a = -RGLRU_C * F.softplus(lam) * r.float()
    a = torch.exp(log_a)
    bterm = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x).float()
    return a, bterm


def rglru_ref(x, r, i, lam):
    """RG-LRU scan: ``repro/models/rglru.py:rglru_scan``.  x, r, i:
    (b, s, w); lam: (w,).  Returns h (b, s, w) in x.dtype.

    The recurrence h_t = a_t h_{t-1} + b_t from h = 0 runs as a log-depth
    doubling scan over time (Hillis-Steele): for d = 1, 2, 4, ... every
    t >= d takes b_t += a_t b_{t-d} and a_t *= a_{t-d}, all at once.  That
    is the associative scan's combine, in another association order."""
    a, h = rglru_coefficients(x, r, i, lam)
    d = 1
    while d < h.shape[1]:
        h = torch.cat([h[:, :d], h[:, d:] + a[:, d:] * h[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return h.to(x.dtype)
