"""Flash attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, pallas_call at line 114, body ``_kernel``).  The
kernel takes q ``(B, H, Sq, D)``, k ``(B, K, Sk, D)`` and v ``(B, K, Sk,
Dv)`` with ``H % K == 0``, fp32 or bf16, ``(D, Dv)`` in
:data:`HEAD_DIM_PAIRS` (equal dims, or MLA's 192 for q and k with 128 for
v; the scale is ``1/sqrt(D)``), any ``Sq`` and
``Sk`` (ragged tiles are masked in the kernel) and any strides whose last
dimension is unit, so the model can hand it transposed views without a
copy (a tensor whose rows are not 16-byte aligned, which the kernel's
asynchronous copies need, is made contiguous first).  The output is a new
contiguous ``(B, H, Sq, Dv)`` tensor in q's type.  fp32 runs on the CUDA
cores, exactly (MLA's pair in a kernel of its own); bf16 on the tensor
cores, one Hopper kernel for every pair: persistent, ``wgmma`` fed by TMA
loads on ``mbarrier``s, the tensor maps encoded per call from the strides.

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`.  On a CUDA tensor it
launches the kernel or raises; it never falls back.  ``launches`` counts
the kernel launches.

:func:`flash_attention_with_grad` is the same forward with gradients: the
backward is the autograd of the plain version, recomputed from the saved
q, k and v (:class:`repro_torch.kernels.autograd.PlainBackward`), since
the JAX package has no backward for B1.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .autograd import PlainBackward
from .ref import flash_attention_ref

NAME = "flash_attention"
#: (head dim of q and k, head dim of v) pairs the kernel is built for
HEAD_DIM_PAIRS = ((64, 64), (128, 128), (192, 128), (256, 256))
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
                       + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def check_inputs(q, k, v, window) -> None:
    """Raise on what the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d: (B, H, Sq, D), (B, K, Sk, D), "
                         "(B, K, Sk, Dv)")
    b, h, sq, d = q.shape
    kb, kh, sk, kd = k.shape
    dv = v.shape[-1]
    if v.shape[:3] != k.shape[:3] or kb != b or kd != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kh < 1 or h % kh:
        raise ValueError(f"query heads {h} not a multiple of kv heads {kh}")
    if (d, dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (q/k {d}, v {dv}) not in "
                         f"{HEAD_DIM_PAIRS}")
    if sq < 1 or sk < 1 or -(-sq // 32) * h * b >= 2 ** 31:  # flat grid
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


def _rows_aligned(t):
    """t itself when every row starts on a 16-byte boundary and no dim
    longer than 1 has stride 0 (the bf16 kernel's TMA maps take positive
    strides only), else a contiguous copy (fresh storage, so aligned)."""
    per = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            st % per == 0 and (st > 0 or n == 1)
            for n, st in zip(t.shape[:3], t.stride()[:3])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Causal / sliding-window GQA attention forward, ``(B, H, Sq, Dv)``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    check_inputs(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    fn, err_str = _kernel_fn()
    q, k, v = _rows_aligned(q), _rows_aligned(k), _rows_aligned(v)
    b, h, sq, d = q.shape
    kh, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, h, sq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], b, h, kh, sq, sk, d, dv, int(causal),
                -1 if window is None else int(window), DTYPES[q.dtype],
                1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    global launches
    launches += 1
    return out


def flash_attention_with_grad(q, k, v, *, causal: bool = True,
                              window: int | None = None,
                              forward=flash_attention) -> torch.Tensor:
    """:func:`flash_attention` with gradients for q, k and v: the forward
    runs ``forward`` (the kernel), the backward the autograd of
    :func:`flash_attention_ref` on the saved inputs."""
    return PlainBackward.apply(forward, flash_attention_ref,
                               {"causal": causal, "window": window}, q, k, v)
