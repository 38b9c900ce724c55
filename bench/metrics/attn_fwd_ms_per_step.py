"""Device ms a step of the kernels launched inside the program's
``kernels.attention <shapes>`` spans (``kernels/ops.py:attention``):
every attention call, in the forward and in the remat recompute (B1 on
the card)."""

from ..spans import span_ms

PREFIX = "kernels.attention "


def read(ctx):
    return span_ms(ctx, PREFIX, prefix=True)
