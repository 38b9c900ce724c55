"""Flash attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, pallas_call at line 114, body ``_kernel``).  The
kernel takes q ``(B, H, Sq, D)`` and k, v ``(B, K, Sk, D)`` with
``H % K == 0``, fp32 or bf16, ``D`` in :data:`HEAD_DIMS`, any ``Sq`` and
``Sk`` (ragged tiles are masked in the kernel) and any strides whose last
dimension is unit, so the model can hand it transposed views without a
copy.  The output is a new contiguous ``(B, H, Sq, D)`` tensor in q's type.

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`.  On a CUDA tensor it
launches the kernel or raises; it never falls back.  ``launches`` counts
the kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_ref

NAME = "flash_attention"
HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12
                       + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def check_inputs(q, k, v, window) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d: (B, H, Sq, D), (B, K, Sk, D)")
    b, h, sq, d = q.shape
    kb, kh, sk, kd = k.shape
    if v.shape != k.shape or kb != b or kd != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kh < 1 or h % kh:
        raise ValueError(f"query heads {h} not a multiple of kv heads {kh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if sq < 1 or sk < 1 or b > 65535 or h > 65535:
        raise ValueError(f"unsupported sizes B={b} H={h} Sq={sq} Sk={sk}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need one "
                        f"of {list(DTYPES)} for all three")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k, v need a unit stride in the head dim")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Causal / sliding-window GQA attention forward, ``(B, H, Sq, D)``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    check_inputs(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    fn, err_str = _kernel_fn()
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], b, h, kh, sq, sk, d, int(causal),
                -1 if window is None else int(window), DTYPES[q.dtype],
                1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    global launches
    launches += 1
    return out
