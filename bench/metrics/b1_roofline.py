"""B1's share of its roofline, %: over the attention forward calls of the
traced steps (the model's ``ops.attention``, which B1 runs; the benchmark
wraps each call in a ``bench.attention_forward`` range and records its
shapes), the sum of each call's bound from its own shapes
(``peaks.attention_bound_s``) over the sum of the device time of the
kernels the calls launched, whatever kernel that is."""

from ..peaks import attention_bound_s

RANGE = "bench.attention_forward"


def read(ctx):
    if ctx.trace is None or ctx.trace_window is None:
        return None
    ranges = ctx.trace.ranges(RANGE)
    if not ranges or len(ranges) != len(ctx.attention_calls):
        return None
    kernels = ctx.trace.launched_in(ranges)
    device_s = sum(k[1] - k[0] for ks in kernels for k in ks) / 1e6
    if device_s <= 0:
        return None
    bound = sum(attention_bound_s(*call) for call in ctx.attention_calls)
    return 100.0 * bound / device_s
