"""Mamba2, the state-space duality (SSD) block [arXiv:2405.21060]: the
PyTorch counterpart of ``repro/models/ssm.py``.

in_proj -> (z gate | x, B, C, dt heads) -> short causal conv on (x, B, C)
-> SSD scan -> gated RMSNorm -> out_proj.  Prefill runs the scan through
:func:`repro_torch.kernels.ops.ssd` under the JAX package's gate
(``ssm.py:170-175``: the kernel policy and a sequence that is a multiple of
the chunk); every other call takes the plain chunked scan
(:func:`repro_torch.kernels.ref.ssd_scan_ref`, the JAX ``ssd_chunked``).
Decode carries (conv state, SSM state), O(1) per token, and is plain, as
in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.policy import use_kernels
from ..kernels.ref import ssd_scan_ref
from ..sharding.hints import (batch_axes, hint, keep_layout, shardwise,
                              split_heads)
from .config import ModelConfig
from .layers import _init, init_rmsnorm, rms_norm


def ssd_decode_step(x, dt, A, B, C, state):
    """Single-token SSD update: state' = state * exp(dt A) + B (dt x)^T;
    y = C . state'.  x: (b,1,h,p); dt: (b,1,h); B, C: (b,1,n); state:
    (b,h,p,n) fp32."""
    a = torch.exp(dt[..., None, None] * A[None, None, :, None, None])[:, 0]
    xbar = (x * dt[..., None])[:, 0]                        # (b,h,p)
    upd = torch.einsum("bn,bhp->bhpn", B[:, 0].to(xbar.dtype), xbar)
    state = state * a + upd
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].to(state.dtype), state)
    return y[:, None].to(x.dtype), state


def init_mamba2(generator, cfg: ModelConfig, dtype, device):
    s = cfg.ssm
    d = cfg.d_model
    din = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = din + 2 * s.d_state
    return {
        "in_proj": _init(generator, (d, 2 * din + 2 * s.d_state + nh), dtype,
                         device),
        "conv_w": _init(generator, (s.d_conv, conv_ch), dtype, device,
                        scale=0.1),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        # A = -exp(A_log); both fp32 whatever the model dtype
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=device),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "norm": init_rmsnorm(din, dtype, device),
        "out_proj": _init(generator, (din, d), dtype, device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d.  x: (b,s,c); w: (k,c); state: (b,k-1,c).
    Returns (out, new state), the state being the last k-1 inputs."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return out + b, new_state


def apply_mamba2(p, x, cfg: ModelConfig, cache=None):
    """x: (b,s,d).  cache: {conv, state} for decode.  Returns
    (y, new_cache); new_cache is None without a cache."""
    s_cfg = cfg.ssm
    d = cfg.d_model
    din = s_cfg.d_inner(d)
    nh = s_cfg.n_heads(d)
    n = s_cfg.d_state
    b, s, _ = x.shape

    # pinned (and its gradient) under the dry run's mesh, where DTensor
    # would otherwise hand the product's gradient over on sequence shards
    zxbcdt = hint(x @ p["in_proj"], batch_axes(), None, "model")
    z, xin, Bc, Cc, dt = torch.split(zxbcdt, [din, din, n, n, nh], dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_state = cache["conv"] if cache else None
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      conv_state)
    conv_out = F.silu(conv_out)
    xin, Bc, Cc = torch.split(conv_out, [din, n, n], dim=-1)

    A = -torch.exp(p["A_log"])
    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = split_heads(xin, nh).reshape(b, s, nh, s_cfg.head_dim)

    if cache is not None:
        y, new_state = ssd_decode_step(xh, dt, A, Bc, Cc, cache["state"])
        new_cache = {"conv": new_conv, "state": new_state}
    else:
        if use_kernels(x.device) and s % s_cfg.chunk == 0:
            y, _ = ops.ssd(xh, dt, A, Bc, Cc, chunk=s_cfg.chunk)
        else:
            # by shards under the dry run's mesh: batch over the batch
            # axes, heads over model
            bd, tp = batch_axes(), "model"
            y, _ = shardwise(
                lambda *a: ssd_scan_ref(*a, s_cfg.chunk),
                (xh, dt, A, Bc, Cc),
                ((bd, None, tp, None), (bd, None, tp), (tp,), (bd,), (bd,)),
                (xh.shape, (b, nh, s_cfg.head_dim, n)),
                ((bd, None, tp, None), (bd, tp, None, None)))
        new_cache = None
    y = y + xh * p["D"][None, None, :, None]
    y = keep_layout(y.reshape(b, s, din))
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], new_cache
