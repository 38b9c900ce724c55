"""Device ms a step of the kernels launched inside the program's
``train.optimizer`` span (``train/steps.py:build_train_step``, around
``apply_updates``): gradient norm, clip and AdamW."""

from ..spans import span_ms

SPAN = "train.optimizer"


def read(ctx):
    return span_ms(ctx, SPAN)
