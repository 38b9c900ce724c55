"""Model FLOPs utilization, %: the model FLOPs of the window's whole steps
(``flops/``: 6 x active parameters a token plus attention's forward and
backward, no recompute) over the window's span and the card's peak in the
configuration's type."""


def read(ctx):
    return 100.0 * ctx.flops_per_step * ctx.steps / ctx.window_s \
        / ctx.peak_flops
