"""Device ms a step of the GEMM kernels (cuBLAS and CUTLASS names) in the
traced steps."""

MARKS = ("gemm", "gemv", "cutlass", "xmma", "splitkreduce")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in MARKS) and "flash" not in low


def read(ctx):
    if ctx.trace is None or ctx.trace_window is None:
        return None
    lo, hi, steps = ctx.trace_window
    us = sum(min(k[1], hi) - max(k[0], lo) for k in ctx.trace.kernels
             if k[1] > lo and k[0] < hi and is_gemm(k[2]))
    return us / 1e3 / steps if us else None
