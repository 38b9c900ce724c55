"""Named ranges inside the port's training step, for ``torch.profiler``.

:class:`span` enters a ``torch.profiler.record_function`` range only while
a profiler records, and checks that when the span is *entered*, not when
it is made: the remat recompute's span is made in the forward and entered
in the backward.  Unrecorded, a span costs one flag read (a bare
``record_function`` costs over ten microseconds of host time even with no
profiler).  A kernel belongs to the span whose host range holds its
launch; the backward's spans run on the autograd engine's thread, so a
reader matches kernels to spans by launch time, not by thread.

The spans of a training step (each family's ranges are disjoint in time):

- :data:`FORWARD` ``train.forward``: each microbatch's loss (embedding,
  blocks, head, fp32 logsumexp and loss);
- :data:`BACKWARD` ``train.backward``: each microbatch's gradients and
  their add into the accumulator (and the last microbatch's divide), with
  the remat recompute and the kernels' plain backward inside;
- :data:`REMAT` ``model.remat_recompute``: each block's re-run in the
  backward (``torch.utils.checkpoint``'s recompute context);
- :data:`OPTIMIZER` ``train.optimizer``: gradient norm, clip and AdamW;
- :data:`ATTENTION` ``kernels.attention <shapes>``: every call of the
  model's attention, in the forward and in the recompute, named by
  :func:`attention_name`;
- ``plain backward: <plain fn name>`` (``kernels/autograd.py``): a
  kernel's backward, its plain version recomputed.
"""

from __future__ import annotations

import re

import torch

FORWARD = "train.forward"
BACKWARD = "train.backward"
REMAT = "model.remat_recompute"
OPTIMIZER = "train.optimizer"
ATTENTION = "kernels.attention"

_ATTENTION_RE = re.compile(
    r"^kernels\.attention q=(\S+) k=(\S+) v=(\S+) (\S+) causal=(True|False)"
    r" window=(None|\d+)$")


def recording() -> bool:
    """Whether a profiler records on this thread (the autograd engine's
    threads inherit the state of the thread that started the backward)."""
    return torch.autograd._profiler_enabled()


class span:
    """``with span(name):`` -- a ``record_function(name)`` range while a
    profiler records, nothing otherwise.  ``name`` may be a callable that
    returns the name, called only when the range is entered."""

    __slots__ = ("name", "_range")

    def __init__(self, name):
        self.name = name
        self._range = None

    def __enter__(self):
        if recording():
            name = self.name() if callable(self.name) else self.name
            self._range = torch.profiler.record_function(name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        rng, self._range = self._range, None
        if rng is not None:
            rng.__exit__(*exc)
        return False


def _dims(shape) -> str:
    return "x".join(str(int(d)) for d in shape)


def attention_name(q, k, v, causal: bool, window) -> str:
    """``kernels.attention q=<B>x<H>x<Sq>x<D> k=<B>x<K>x<Sk>x<D>
    v=<B>x<K>x<Sk>x<Dv> <dtype> causal=<True|False> window=<None|int>``:
    the shapes, q's dtype without ``torch.``, ``causal`` and ``window`` of
    one attention call (a range's ``args`` do not reach the chrome trace,
    so they go in its name)."""
    return (f"{ATTENTION} q={_dims(q.shape)} k={_dims(k.shape)} "
            f"v={_dims(v.shape)} {str(q.dtype).removeprefix('torch.')} "
            f"causal={bool(causal)} window={window}")


def parse_attention_name(name: str):
    """:func:`attention_name`'s name -> (q shape, k shape, v shape,
    causal, window, dtype), or None for another name."""
    m = _ATTENTION_RE.match(name)
    if m is None:
        return None
    q, k, v, dtype, causal, window = m.groups()

    def shape(s):
        return tuple(int(d) for d in s.split("x"))
    return (shape(q), shape(k), shape(v), causal == "True",
            None if window == "None" else int(window), dtype)
