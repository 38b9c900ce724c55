"""Gradients through the port's kernels.

None of the three TPU kernels has a backward in the JAX package: there is
no ``custom_vjp`` under ``repro/kernels``, and its trainer differentiates
the jnp oracles of ``repro/kernels/ref.py``.  So no backward kernel is
owed, and each kernel's backward here is the autograd of its plain version
(:mod:`repro_torch.kernels.ref`), recomputed from the saved inputs.  The
forward always runs the kernel; only the backward is the plain version's.

:class:`PlainBackward` takes the forward callable as an argument, so a CPU
test can run it with the plain version in the kernel's place and hold its
gradients to plain autograd bit for bit.  Each kernel module wraps it once
(``flash_attention_with_grad``, ``ssd_scan_with_grad``,
``rglru_scan_with_grad``).  The kernel's launch count moves in the forward
only: the backward launches no kernel of the port.
"""

from __future__ import annotations

import torch

from ..spans import span

#: the prefix of the profiler range (a :class:`repro_torch.spans.span`)
#: around each plain recompute in the backward, followed by the plain
#: version's name
RANGE_PREFIX = "plain backward: "


class PlainBackward(torch.autograd.Function):
    """``forward(*inputs, **kwargs)`` in the forward; in the backward, the
    gradients of ``plain(*inputs, **kwargs)`` with respect to the inputs
    that need one, from the saved inputs.  An output that receives no
    gradient (``None``) takes no part in the backward."""

    @staticmethod
    def forward(ctx, forward, plain, kwargs, *inputs):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return forward(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        none = (None,) * (3 + len(need))
        with span(RANGE_PREFIX + ctx.plain.__name__):
            with torch.enable_grad():
                inputs = [t.detach().requires_grad_(n)
                          for t, n in zip(ctx.saved_tensors, need)]
                outs = ctx.plain(*inputs, **ctx.kwargs)
            if not isinstance(outs, tuple):
                outs = (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [t for t in inputs if t.requires_grad]
            if not pairs or not wrt:
                return none
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True))
        return (None, None, None) + tuple(next(got) if n else None
                                          for n in need)
