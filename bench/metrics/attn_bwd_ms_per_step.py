"""Device ms a step of the kernels launched inside the program's
``plain backward: flash_attention...`` ranges (``kernels/autograd.py``):
B1's backward, the plain version recomputed.  This is the profiler's
reading: the kernels' own time, not the span between the range's ends."""

PREFIX = "plain backward: flash_attention"


def read(ctx):
    if ctx.trace is None or ctx.trace_window is None:
        return None
    lo, hi, steps = ctx.trace_window
    ranges = [r for r in ctx.trace.ranges(PREFIX) if lo <= r[0] <= hi]
    us = sum(k[1] - k[0] for ks in ctx.trace.launched_in(ranges)
             for k in ks)
    return us / 1e3 / steps if us else None
