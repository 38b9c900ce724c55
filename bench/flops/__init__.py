"""Model FLOPs of a training step, one module a ``model_type``.

Each module gives ``active_params(conf)``: the parameters a token's
forward multiplies by (the output head counted once, as its GEMM; the
embedding lookup, a gather, not), and ``attention(conf)``: the layers'
attention as (layers, heads, D, Dv).  :func:`step_flops` turns them into
a step's model FLOPs: 6 x active parameters a token, plus attention's
forward and backward, 3 x 2 x (visible causal pairs) x (D + Dv) x heads
for each layer and row.  Recompute is not counted."""

from __future__ import annotations

import importlib

from ..peaks import visible_pairs


def module(model_type: str):
    return importlib.import_module(f"{__name__}.{model_type}")


def step_flops(conf: dict, traffic: dict) -> float:
    """Model FLOPs of one step of ``traffic``'s rows (a packed row attends
    causally over its whole context)."""
    arch = module(conf["model_type"])
    rows, ctx = traffic["rows"], traffic["context"]
    dense = 6.0 * arch.active_params(conf) * rows * ctx
    layers, heads, d, dv = arch.attention(conf)
    attn = 3 * 2.0 * visible_pairs(ctx, ctx, True) * (d + dv) * heads \
        * layers * rows
    return dense + attn
