"""The program's own spans in the recorded step (``repro_torch/spans.py``:
``torch.profiler.record_function`` ranges the training step enters while a
profiler records), read as device time: the kernels whose launch lies
inside a span, matched by launch time (:meth:`trace.Trace.launched_in`),
so the backward's kernels, launched from the autograd engine's thread,
fall in the main thread's ``train.backward``.  A program without the
spans reads None."""

from __future__ import annotations


def span_ms(ctx, name: str, prefix: bool = False):
    """Device ms a step of the kernels launched inside the recorded step's
    ranges called ``name`` (with ``prefix``: whose name starts with it),
    or None where the trace holds no such range or no kernel in one."""
    if ctx.trace is None or ctx.trace_window is None:
        return None
    lo, hi, steps = ctx.trace_window
    ranges = [r for r in ctx.trace.ranges(name) if lo <= r[0] <= hi
              and (prefix or r[2] == name)]
    if not ranges:
        return None
    us = sum(k[1] - k[0] for ks in ctx.trace.launched_in(ranges)
             for k in ks)
    return us / 1e3 / steps if us else None
