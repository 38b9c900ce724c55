"""Device ms a step of the kernels launched inside the program's
``train.forward`` spans (``train/steps.py:accumulate_grads``, one a
microbatch): embedding, blocks, head, fp32 logsumexp and loss."""

from ..spans import span_ms

SPAN = "train.forward"


def read(ctx):
    return span_ms(ctx, SPAN)
