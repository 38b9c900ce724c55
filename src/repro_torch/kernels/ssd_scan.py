"""Mamba2 SSD chunked scan on Hopper: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``,
pallas_call at line 92, body ``_kernel``).  Same contract: x (b, s, h, p),
dt (b, s, h) softplus-ed, A (h,), B and C (b, s, n); returns y (b, s, h, p)
in x's type and the final state (b, h, p, n) in fp32.  As in the JAX
wrapper, ``la = dt * A`` is formed in fp32 and ``xbar = x * dt`` in x's
type here, and the kernel takes la, xbar, B and C.  It takes x, B and C
of one type, fp32 or bf16, p in :data:`HEAD_DIMS`, n up to :data:`MAX_STATE`
and any s that is a multiple of ``chunk`` (the JAX gate).

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.ssd_scan_ref`.  On a CUDA tensor it launches
the kernel or raises; it never falls back.  ``launches`` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_scan_ref

NAME = "ssd_scan"
HEAD_DIMS = (32, 64, 128)
MAX_STATE = 128
MAX_CHUNK = 2048
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        lib = _build.load(NAME)
        fn = lib.ssd_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.ssd_scan_error_string)
    return _fn


def eligible(x_shape, n: int, chunk: int) -> bool:
    """Whether the kernel takes x (b, s, h, p) with d_state ``n`` and
    ``chunk``: p in :data:`HEAD_DIMS`, 1 <= n <= :data:`MAX_STATE`,
    1 <= chunk <= :data:`MAX_CHUNK` and s a multiple of chunk."""
    if len(x_shape) != 4:
        return False
    b, s, h, p = x_shape
    return (b >= 1 and h >= 1 and s >= 1 and p in HEAD_DIMS
            and 1 <= n <= MAX_STATE and 1 <= chunk <= MAX_CHUNK
            and s % chunk == 0 and b * h < 2 ** 31)


def check_inputs(x, dt, A, B, C, chunk) -> None:
    """Raise on what the kernel does not take."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3:
        raise ValueError("need x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n)")
    b, s, h, p = x.shape
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or B.shape[:2] != (b, s) or C.shape != B.shape):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if not eligible(x.shape, B.shape[-1], chunk):
        raise ValueError(
            f"the SSD kernel does not take x {tuple(x.shape)}, d_state "
            f"{B.shape[-1]}, chunk {chunk}: it needs head dim in "
            f"{HEAD_DIMS}, d_state <= {MAX_STATE}, chunk <= {MAX_CHUNK} "
            f"and a sequence that is a multiple of the chunk")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"dtypes x {x.dtype}, B {B.dtype}, C {C.dtype}: "
                        f"need one of {list(DTYPES)} for all three")
    if not (x.device == dt.device == A.device == B.device == C.device):
        raise ValueError("x, dt, A, B, C must lie on one device")


def prepare(x, dt, A, B, C):
    """The kernel's inputs, formed as the JAX wrapper forms them:
    ``la = dt * A`` in fp32 and ``xbar = x * dt`` in x's type, all
    contiguous."""
    la = (dt * A[None, None, :]).float().contiguous()
    xbar = (x * dt[..., None].to(x.dtype)).contiguous()
    return la, xbar, B.contiguous(), C.contiguous()


def launch(la, xbar, B, C, *, chunk: int):
    """One launch of the kernel on prepared inputs -> (y, state).  Counts
    nothing: :func:`ssd_scan` is the counted entry point."""
    fn, err_str = _kernel_fn()
    b, s, h, p = xbar.shape
    n = B.shape[-1]
    y = torch.empty_like(xbar)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=xbar.device)
    with torch.cuda.device(xbar.device):
        stream = torch.cuda.current_stream(xbar.device).cuda_stream
        rc = fn(la.data_ptr(), xbar.data_ptr(), B.data_ptr(), C.data_ptr(),
                y.data_ptr(), state.data_ptr(), b, s, h, p, n, chunk,
                DTYPES[xbar.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    return y, state


def ssd_scan(x, dt, A, B, C, *, chunk: int):
    """Chunked SSD scan -> (y (b,s,h,p) in x.dtype, state (b,h,p,n) fp32)."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk)
    check_inputs(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = launch(*prepare(x, dt, A, B, C), chunk=chunk)
    global launches
    launches += 1
    return out
