"""Mamba2 SSD chunked scan on Hopper: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``,
pallas_call at line 92, body ``_kernel``).  Same contract: x (b, s, h, p),
dt (b, s, h) softplus-ed, A (h,), B and C (b, s, n); returns y (b, s, h, p)
in x's type and the final state (b, h, p, n) in fp32.  It takes x, B and C
of one type, fp32 or bf16, p in :data:`HEAD_DIMS`, n up to
:data:`MAX_STATE` and any s that is a multiple of ``chunk`` (the JAX gate).
B and C are read through their row strides, so the model's column slices
of the convolution output reach the kernel without a copy.

Each type has a design of its own.  fp32 runs on the CUDA cores, exact
with TF32 off: as in the JAX wrapper, ``la = dt * A`` (fp32) and
``xbar = x * dt`` are formed here, and one call issues three CUDA
launches (chunk states, the state pass, the outputs) into two fp32 scratch
arrays allocated here.  bf16 runs its products on the tensor cores
(``wgmma``): it takes x (through its row strides, like B and C), dt and A
as they are and forms la and the dt scaling inside, and one call issues
two CUDA launches (chunk states with the carry, the outputs) into two
scratch arrays allocated here.  Either counts as one launch.

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.ssd_scan_ref`.  On a CUDA tensor it launches
the kernel or raises; it never falls back.  ``launches`` counts the kernel
launches.

:func:`ssd_scan_with_grad` is the same forward with gradients for x, dt,
A, B and C through both outputs: the backward is the autograd of the plain
version, recomputed from the saved inputs
(:class:`repro_torch.kernels.autograd.PlainBackward`), since the JAX
package has no backward for B2.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .autograd import PlainBackward
from .ref import ssd_scan_ref

NAME = "ssd_scan"
HEAD_DIMS = (32, 64, 128)
MAX_STATE = 128
MAX_CHUNK = 2048
DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches since the count was last set to 0
launches = 0

_fns = None


def _kernel_fns():
    """(fp32 entry, bf16 entry, error string) of the built library."""
    global _fns
    if _fns is None:
        lib = _build.load(NAME)
        f32 = lib.ssd_scan_fwd
        f32.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4
                        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        f32.restype = ctypes.c_int
        bf = lib.ssd_scan_bf16_fwd
        bf.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        bf.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _fns = (f32, bf, lib.ssd_scan_error_string)
    return _fns


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


def _rows_aligned(t) -> bool:
    """Whether the kernel can copy the rows of t (b, s, n) as 16-byte
    chunks: unit last stride, n a multiple of 8, base and row strides
    16-byte aligned."""
    per = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.shape[-1] % 8 == 0
            and t.data_ptr() % 16 == 0 and t.stride(0) % per == 0
            and t.stride(1) % per == 0)


def _heads_aligned(x) -> bool:
    """Whether the bf16 kernel can read x (b, s, h, p) as it is: each
    position's h heads of p one after another, rows 16-byte aligned."""
    return (x.stride(3) == 1 and x.stride(2) == x.shape[3]
            and x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0
            and x.stride(1) % 8 == 0)


class F32Inputs(NamedTuple):
    """The fp32 design's inputs: ``la = dt * A`` and ``xbar = x * dt``."""
    la: torch.Tensor
    xbar: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor


class Bf16Inputs(NamedTuple):
    """The bf16 design's inputs: it forms la and the dt scaling itself."""
    dt: torch.Tensor
    x: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    A: torch.Tensor


def prepare(x, dt, A, B, C) -> F32Inputs | Bf16Inputs:
    """The kernel's inputs.  fp32: :class:`F32Inputs`, formed as the JAX
    wrapper forms them, la and xbar in fp32, both contiguous.  bf16:
    :class:`Bf16Inputs`, dt and A fp32 and contiguous, x as it is where
    :func:`_heads_aligned` (the model's head view of the convolution output
    is), else a contiguous copy.  B and C pass as they are when their rows
    are aligned (the model's column slices are); otherwise they are copied,
    with n padded by zeros to a multiple of 8, which changes no product."""
    n8 = -(-B.shape[-1] // 8) * 8

    def rows(t):
        return t if _rows_aligned(t) else F.pad(
            t, (0, n8 - t.shape[-1])).contiguous()
    if x.dtype == torch.bfloat16:
        return Bf16Inputs(dt.float().contiguous(),
                          x if _heads_aligned(x) else x.contiguous(),
                          rows(B), rows(C), A.float().contiguous())
    la = (dt * A[None, None, :]).float().contiguous()
    xbar = (x * dt[..., None].to(x.dtype)).contiguous()
    return F32Inputs(la, xbar, rows(B), rows(C))


def launch(inp: F32Inputs | Bf16Inputs, *, chunk: int,
           n: int | None = None):
    """One call of the kernel on :func:`prepare`'s inputs -> (y, state),
    with the state cut to the first ``n`` columns where :func:`prepare`
    padded B and C.  Counts nothing: :func:`ssd_scan` is the counted entry
    point."""
    f32, bf, err_str = _kernel_fns()
    xin = inp.x if isinstance(inp, Bf16Inputs) else inp.xbar
    b, s, h, p = xin.shape
    npad = inp.B.shape[-1]
    B, C = inp.B, inp.C
    dev = xin.device
    y = torch.empty((b, s, h, p), dtype=xin.dtype, device=dev)
    state = torch.empty((b, h, p, npad), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if isinstance(inp, Bf16Inputs):
            pt = 64 if p <= 64 else 128
            carried = torch.empty((b, s // chunk, h, 2, pt, MAX_STATE),
                                  dtype=torch.bfloat16, device=dev)
            rows = torch.empty((b, h, s, 4), dtype=torch.float32, device=dev)
            rc = bf(xin.data_ptr(), inp.dt.data_ptr(), inp.A.data_ptr(),
                    B.data_ptr(), C.data_ptr(), y.data_ptr(),
                    state.data_ptr(), carried.data_ptr(), rows.data_ptr(),
                    xin.stride(0), xin.stride(1), B.stride(0), B.stride(1),
                    C.stride(0), C.stride(1), b, s, h, p, npad, chunk, stream)
        else:
            chunk_states = torch.empty((b, s // chunk, h, p, npad),
                                       dtype=torch.float32, device=dev)
            cum = torch.empty((b, h, s), dtype=torch.float32, device=dev)
            rc = f32(inp.la.data_ptr(), xin.data_ptr(), B.data_ptr(),
                     C.data_ptr(), y.data_ptr(), state.data_ptr(),
                     chunk_states.data_ptr(), cum.data_ptr(), B.stride(0),
                     B.stride(1), C.stride(0), C.stride(1), b, s, h, p, npad,
                     chunk, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: "
                           f"{err_str(rc).decode()} (cudaError {rc})")
    if n is not None and n != npad:
        state = state[..., :n].contiguous()
    return y, state


def ssd_scan(x, dt, A, B, C, *, chunk: int):
    """Chunked SSD scan -> (y (b,s,h,p) in x.dtype, state (b,h,p,n) fp32)."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk)
    check_inputs(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = launch(prepare(x, dt, A, B, C), chunk=chunk, n=B.shape[-1])
    global launches
    launches += 1
    return out


def ssd_scan_with_grad(x, dt, A, B, C, *, chunk: int, forward=ssd_scan):
    """:func:`ssd_scan` with gradients: the forward runs ``forward`` (the
    kernel), the backward the autograd of :func:`ssd_scan_ref` on the saved
    inputs.  Either output may go without a gradient."""
    return PlainBackward.apply(forward, ssd_scan_ref, {"chunk": chunk},
                               x, dt, A, B, C)
