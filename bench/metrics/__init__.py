"""One reader a metric: ``metrics/<name>.py`` defines ``read(ctx)``, which
returns the metric's value from a run's :class:`Context`, or None where
the run holds nothing to read (the metric is then left out of the line).
A share of a roofline or of a peak is never returned as 0 for want of a
reading."""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field


@dataclass
class Context:
    """What a run measured, for the readers."""
    setup_s: float                  # process start -> the first timed step
    window_s: float                 # first timed step's start -> last's end
    steps: int                      # whole steps in the window
    tokens_per_step: int            # rows x context
    flops_per_step: float           # model FLOPs of a step (flops/)
    peak_flops: float               # the card's peak in the config's type
    window_peak_bytes: int          # max_memory_allocated over the window
    trace: object = None            # trace.Trace of a --trace 1 run
    trace_window: tuple | None = None   # (start us, end us, steps)
    attention_calls: list = field(default_factory=list)


def reader(name: str):
    return importlib.import_module(f"{__name__}.{name}").read
