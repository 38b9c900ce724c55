"""RG-LRU recurrent block (RecurrentGemma / Griffin [arXiv:2402.19427]):
the PyTorch counterpart of ``repro/models/rglru.py``.

    r_t = sigmoid(W_a x_t)           (recurrence gate)
    i_t = sigmoid(W_x x_t)           (input gate)
    a_t = exp(-c softplus(Lambda) r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

Prefill runs the scan through :func:`repro_torch.kernels.ops.rglru` under
the JAX package's gate (``rglru.py:85-90``: the kernel policy, and a
sequence and width that are multiples of 128); every other call takes the
plain scan (:func:`repro_torch.kernels.ref.rglru_ref`).  Decode carries h
and is plain, as in the JAX package.  The block wraps the RG-LRU
Griffin-style: a GeLU gate branch and a conv + RG-LRU signal branch,
merged multiplicatively.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.policy import use_kernels
from ..kernels.ref import rglru_coefficients, rglru_ref
from .config import ModelConfig
from .layers import _init
from .ssm import _causal_conv


def rglru_decode_step(x, r, i, lam, h_prev):
    """One-step recurrence: x, r, i: (b,1,w); h_prev: (b,w) fp32.
    Returns (y (b,1,w) in x.dtype, h (b,w) fp32)."""
    a, b_t = rglru_coefficients(x[:, 0], r[:, 0], i[:, 0], lam)
    h = a * h_prev + b_t
    return h[:, None].to(x.dtype), h


def init_recurrent_block(generator, cfg: ModelConfig, dtype, device):
    hy = cfg.hybrid
    d = cfg.d_model
    w = hy.lru_width or d
    return {
        "in_x": _init(generator, (d, w), dtype, device),
        "in_gate": _init(generator, (d, w), dtype, device),
        "conv_w": _init(generator, (hy.conv_width, w), dtype, device,
                        scale=0.1),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "gate_r": _init(generator, (w, w), dtype, device),
        "gate_i": _init(generator, (w, w), dtype, device),
        # fp32 whatever the model dtype, as in the JAX package
        "lam": torch.full((w,), 1.0, dtype=torch.float32, device=device),
        "out": _init(generator, (w, d), dtype, device),
    }


def apply_recurrent_block(p, x, cfg: ModelConfig, cache=None):
    """Griffin recurrent branch.  cache: {conv, h}.  Returns
    (y, new_cache); new_cache is None without a cache."""
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(x @ p["in_gate"], approximate="tanh")
    sig = x @ p["in_x"]
    conv_state = cache["conv"] if cache else None
    sig, new_conv = _causal_conv(sig, p["conv_w"], p["conv_b"], conv_state)
    r = torch.sigmoid(sig @ p["gate_r"])
    i = torch.sigmoid(sig @ p["gate_i"])
    if cache is not None:
        y, new_h = rglru_decode_step(sig, r, i, p["lam"], cache["h"])
        new_cache = {"conv": new_conv, "h": new_h}
    else:
        if use_kernels(x.device) and sig.shape[1] % 128 == 0 \
                and sig.shape[2] % 128 == 0:
            y = ops.rglru(sig, r, i, p["lam"])
        else:
            y = rglru_ref(sig, r, i, p["lam"])
        new_cache = None
    return (y * gate) @ p["out"], new_cache
