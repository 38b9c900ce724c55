"""Device ms a step of the kernels launched inside the program's
``train.backward`` spans (``train/steps.py:accumulate_grads``, one a
microbatch): the whole backward, with the remat recompute and the
kernels' plain backward inside it, and the gradients' accumulation."""

from ..spans import span_ms

SPAN = "train.backward"


def read(ctx):
    return span_ms(ctx, SPAN)
