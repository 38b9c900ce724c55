"""RG-LRU scan on Hopper: the wrapper of ``csrc/rglru_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``rglru_pallas``, pallas_call at line 70, body ``_kernel``).  Same
contract: x, r, i (b, s, w), lam (w,); returns h (b, s, w) in x's type.  As
in the JAX wrapper, a = exp(-8 softplus(lam) r) and
b = sqrt(max(1 - a^2, 1e-12)) (i x) are formed in fp32 here
(:func:`repro_torch.kernels.ref.rglru_coefficients`) and the kernel runs
the recurrence.  It takes any b, s and w, and x of type fp32 or bf16.

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.rglru_ref`.  On a CUDA tensor it launches the
kernel or raises; it never falls back.  ``launches`` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rglru_coefficients, rglru_ref

NAME = "rglru_scan"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.rglru_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.rglru_scan_error_string)
    return _fn


def eligible(x_shape) -> bool:
    """Whether the kernel takes x (b, s, w): any sizes, b <= 65535."""
    return len(x_shape) == 3 and 1 <= x_shape[0] <= 65535 \
        and x_shape[1] >= 1 and x_shape[2] >= 1


def check_inputs(x, r, i, lam) -> None:
    """Raise on what the kernel does not take."""
    if not eligible(x.shape):
        raise ValueError(f"the RG-LRU kernel does not take x "
                         f"{tuple(x.shape)}: it needs (b, s, w) with "
                         f"1 <= b <= 65535")
    if r.shape != x.shape or i.shape != x.shape or \
            tuple(lam.shape) != (x.shape[2],):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, r "
                         f"{tuple(r.shape)}, i {tuple(i.shape)}, lam "
                         f"{tuple(lam.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"dtype {x.dtype}: need one of {list(DTYPES)}")
    if not (x.device == r.device == i.device == lam.device):
        raise ValueError("x, r, i, lam must lie on one device")


def launch(a, bterm, out_dtype):
    """One launch of the kernel on fp32 (b, s, w) coefficients -> y in
    ``out_dtype``.  Counts nothing: :func:`rglru_scan` is the counted entry
    point."""
    fn, err_str = _kernel_fn()
    a, bterm = a.contiguous(), bterm.contiguous()
    b, s, w = a.shape
    y = torch.empty((b, s, w), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), bterm.data_ptr(), y.data_ptr(), b, s, w,
                DTYPES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    return y


def rglru_scan(x, r, i, lam):
    """RG-LRU scan -> h (b, s, w) in x.dtype."""
    if x.device.type == "cpu":
        return rglru_ref(x, r, i, lam)
    check_inputs(x, r, i, lam)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = launch(*rglru_coefficients(x, r, i, lam), x.dtype)
    global launches
    launches += 1
    return y
