"""The device's idle share of the traced steps, %: 1 - (the union of
kernel and copy intervals over all streams) / (the span from the first
traced step's start to the last one's end)."""

from ..trace import busy_us


def read(ctx):
    if ctx.trace is None or ctx.trace_window is None:
        return None
    lo, hi, _ = ctx.trace_window
    return 100.0 * (1.0 - busy_us(ctx.trace, lo, hi) / (hi - lo))
