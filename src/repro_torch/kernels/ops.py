"""Dispatch between the Hopper kernels and their plain versions.

The model layers call these functions, under the JAX package's gates, so
:func:`policy.set_policy` moves every hot spot between the kernels and the
plain versions without touching model code.  A call sent to a kernel goes
through the kernel's ``*_with_grad`` entry, whose backward is the autograd
of the plain version: a training step differentiates through every
kernel, and without autograd (serving) it is the kernel's call alone.
"""

from __future__ import annotations

from .flash_attention import flash_attention_with_grad
from .policy import select_attention_impl, select_rglru_impl, select_ssd_impl
from .ref import flash_attention_ref, rglru_ref, ssd_scan_ref
from .rglru_scan import rglru_scan_with_grad
from .ssd_scan import ssd_scan_with_grad


def attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q: (B, H, Sq, D); k: (B, K, Sk, D); v: (B, K, Sk, Dv)."""
    if select_attention_impl(q.shape, k.shape, q.device,
                             v.shape) == "cuda":
        return flash_attention_with_grad(q, k, v, causal=causal,
                                         window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def ssd(x, dt, A, B, C, *, chunk: int):
    """x: (b,s,h,p); dt: (b,s,h); A: (h,); B/C: (b,s,n) ->
    (y, final state)."""
    if select_ssd_impl(x.shape, B.shape[-1], chunk, x.device) == "cuda":
        return ssd_scan_with_grad(x, dt, A, B, C, chunk=chunk)
    return ssd_scan_ref(x, dt, A, B, C, chunk)


def rglru(x, r, i, lam):
    """x, r, i: (b,s,w); lam: (w,) -> h (b,s,w)."""
    if select_rglru_impl(x.shape, x.device) == "cuda":
        return rglru_scan_with_grad(x, r, i, lam)
    return rglru_ref(x, r, i, lam)
