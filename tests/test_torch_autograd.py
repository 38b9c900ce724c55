"""Gradients through the port's kernels (``kernels/autograd.py``).

Each kernel's ``*_with_grad`` entry runs its forward callable and, in the
backward, the autograd of the plain version recomputed from the saved
inputs.  Here the forward is swapped for the plain version itself, so the
whole Function runs on the CPU, and its gradients are held to plain
autograd of the same function bit for bit.  The kernels themselves are held
to the same contract on the card in ``tests/test_torch_gpu.py``.  Imports
no JAX.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention_with_grad
from repro_torch.kernels.ref import flash_attention_ref, rglru_ref, ssd_scan_ref
from repro_torch.kernels.rglru_scan import rglru_scan_with_grad
from repro_torch.kernels.ssd_scan import ssd_scan_with_grad


def _leaves(rng, *shapes):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .requires_grad_() for s in shapes]


def _attention_inputs(rng):
    return _leaves(rng, (2, 4, 64, 16), (2, 2, 64, 16), (2, 2, 64, 16))


def _ssd_inputs(rng):
    x, dt_raw, a_log, B, C = _leaves(rng, (2, 64, 3, 8), (2, 64, 3), (3,),
                                     (2, 64, 5), (2, 64, 5))
    return x, dt_raw, a_log, B, C


def _ssd_args(x, dt_raw, a_log, B, C):
    """The model's own transforms before the scan, so the gradients reach
    the leaves through them: dt softplus-ed, A = -exp(a_log)."""
    return x, F.softplus(dt_raw), -torch.exp(a_log), B, C


def _rglru_inputs(rng):
    return _leaves(rng, (2, 48, 24), (2, 48, 24), (2, 48, 24), (24,))


def _rglru_args(x, r_raw, i_raw, lam):
    return x, torch.sigmoid(r_raw), torch.sigmoid(i_raw), lam


def _grads(out_fn, leaves, seed_grads):
    outs = out_fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, seed_grads) if g is not None]
    return torch.autograd.grad([o for o, _ in pairs], leaves,
                               [g for _, g in pairs], allow_unused=True)


def _same_grads(run_fn, plain_fn, make, out_shapes, which):
    rng = np.random.default_rng(0)
    leaves = make(rng)
    seeds = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             if w else None for s, w in zip(out_shapes, which)]
    got = _grads(run_fn, leaves, seeds)
    want = _grads(plain_fn, leaves, seeds)
    assert any(w is not None for w in want)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


def test_flash_attention_function_grads_equal_plain_autograd():
    kw = dict(causal=True, window=40)
    _same_grads(
        lambda q, k, v: flash_attention_with_grad(
            q, k, v, forward=flash_attention_ref, **kw),
        lambda q, k, v: flash_attention_ref(q, k, v, **kw),
        _attention_inputs, [(2, 4, 64, 16)], [True])


@pytest.mark.parametrize("which", [(True, True), (True, False),
                                   (False, True)],
                         ids=["y+state", "y only", "state only"])
def test_ssd_function_grads_equal_plain_autograd(which):
    """Both outputs take a gradient, and either may go without one (C
    does not reach the final state, so it gets none from the state
    alone)."""
    _same_grads(
        lambda *a: ssd_scan_with_grad(*_ssd_args(*a), chunk=16,
                                      forward=ssd_scan_ref),
        lambda *a: ssd_scan_ref(*_ssd_args(*a), chunk=16),
        _ssd_inputs, [(2, 64, 3, 8), (2, 3, 8, 5)], which)


def test_rglru_function_grads_equal_plain_autograd():
    """lam takes a gradient too."""
    _same_grads(
        lambda *a: rglru_scan_with_grad(*_rglru_args(*a),
                                        forward=rglru_ref),
        lambda *a: rglru_ref(*_rglru_args(*a)),
        _rglru_inputs, [(2, 48, 24)], [True])
    rng = np.random.default_rng(1)
    leaves = _rglru_inputs(rng)
    y = rglru_scan_with_grad(*_rglru_args(*leaves), forward=rglru_ref)
    (glam,) = torch.autograd.grad(y.sum(), [leaves[3]])
    assert glam.abs().sum() > 0


def test_forward_runs_the_given_callable_once_and_backward_the_plain():
    """The forward callable runs once per call and never in the backward;
    the backward recomputes through the plain version."""
    calls = {"fwd": 0}

    def counted(*a, **kw):
        calls["fwd"] += 1
        return flash_attention_ref(*a, **kw)

    q, k, v = _attention_inputs(np.random.default_rng(2))
    out = flash_attention_with_grad(q, k, v, forward=counted)
    assert calls["fwd"] == 1 and out.grad_fn is not None
    out.sum().backward()
    assert calls["fwd"] == 1
    assert all(t.grad is not None for t in (q, k, v))


def test_inputs_that_need_no_grad_get_none():
    rng = np.random.default_rng(3)
    x, r, i, lam = _rglru_inputs(rng)
    x = x.detach()
    y = rglru_scan_with_grad(x, torch.sigmoid(r), torch.sigmoid(i), lam,
                             forward=rglru_ref)
    y.sum().backward()
    assert x.grad is None and r.grad is not None and lam.grad is not None


def test_without_autograd_the_function_is_the_forward_alone():
    """Under ``inference_mode`` (serving) the output is the forward's,
    with no graph."""
    q, k, v = (t.detach() for t in _attention_inputs(
        np.random.default_rng(4)))
    with torch.inference_mode():
        out = flash_attention_with_grad(q, k, v, forward=flash_attention_ref)
        want = flash_attention_ref(q, k, v)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, want)


def test_remat_runs_the_forward_again_in_the_recompute():
    """Under non-reentrant checkpointing (``forward(remat=True)``) the
    forward callable runs once in the forward and once in the backward's
    recompute: the launches a training step counts per layer."""
    from torch.utils.checkpoint import checkpoint
    calls = {"fwd": 0}

    def counted(*a, **kw):
        calls["fwd"] += 1
        return flash_attention_ref(*a, **kw)

    q, k, v = _attention_inputs(np.random.default_rng(5))
    out = checkpoint(lambda q, k, v: flash_attention_with_grad(
        q, k, v, forward=counted) * 2.0, q, k, v, use_reentrant=False)
    assert calls["fwd"] == 1
    out.sum().backward()
    assert calls["fwd"] == 2
    want = torch.autograd.grad(
        (flash_attention_ref(q, k, v) * 2.0).sum(), [q, k, v])
    assert all(torch.equal(t.grad, w) for t, w in zip((q, k, v), want))
