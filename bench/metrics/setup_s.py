"""Seconds from the process's start to the first timed step: imports, the
kernels' build on a checkout's first run, weights, the checked steps."""


def read(ctx):
    return ctx.setup_s
