"""Device ms a step of the kernels launched inside the program's
``model.remat_recompute`` spans (``models/model.py``, the recompute
context of ``torch.utils.checkpoint``): each block's re-run in the
backward, B1's forward included."""

from ..spans import span_ms

SPAN = "model.remat_recompute"


def read(ctx):
    return span_ms(ctx, SPAN)
