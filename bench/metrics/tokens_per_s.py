"""Tokens fed a second: rows x context x whole steps over the window's
span, from the first timed step's start to the last one's end."""


def read(ctx):
    return ctx.tokens_per_step * ctx.steps / ctx.window_s
