"""``runtime.torch_ops`` kind for kind against the JAX package's
``core.op_semantics``.

Each compute kind of the graph IR, forward and backward, runs through the
torch port and through the JAX package's numpy ``local_apply`` /
``stacked_apply`` (``repro.core.op_semantics``, which imports no JAX) on
the same inputs, and the results are cast through ``result_dtype`` as
both executors cast them.  The port's own copy of ``op_semantics`` (what
its ``SimulatorExecutor`` runs) must equal the JAX package's bit for bit
on every kind.  On integer-valued float32 inputs the arithmetic of
most kinds is exact, so they must agree bit for bit.  Kinds that go
through a transcendental function (gelu, silu, softmax, attention and
their grads), or that sum non-integer products whose order numpy and
torch choose differently (the norm grads), agree to float32 tolerance.
"""

import numpy as np
import pytest
import torch

from repro.core import op_semantics as ops_np
from repro_torch.core import op_semantics as ops_copy
from repro_torch.runtime import torch_ops

CLOSE = {"gelu", "silu", "softmax", "attention", "gelu_grad", "silu_grad",
         "attn_grad_q", "attn_grad_k", "attn_grad_v", "norm_grad_x",
         "norm_grad_w"}


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _ids(rng, shape, vocab):
    return rng.integers(0, vocab, shape).astype(np.int32)


#: kind -> (inputs from rng, attrs, local output shape)
CASES = {
    "gelu": (lambda r: [_ints(r, (3, 5))], {}, (3, 5)),
    "relu": (lambda r: [_ints(r, (3, 5))], {}, (3, 5)),
    "scale": (lambda r: [_ints(r, (3, 5))], {"factor": 0.25}, (3, 5)),
    "add": (lambda r: [_ints(r, (3, 5)), _ints(r, (3, 5))], {}, (3, 5)),
    "mul": (lambda r: [_ints(r, (3, 5)), _ints(r, (3, 5))], {}, (3, 5)),
    "dot": (lambda r: [_ints(r, (2, 3, 4)), _ints(r, (4, 6))], {},
            (2, 3, 6)),
    "sum": (lambda r: [_ints(r, (3, 4, 5))], {"dim": 1}, (3, 5)),
    "transpose": (lambda r: [_ints(r, (3, 4, 5))], {"perm": (2, 0, 1)},
                  (5, 3, 4)),
    "reshape": (lambda r: [_ints(r, (3, 4, 5))], {}, (12, 5)),
    "embedding": (lambda r: [_ints(r, (10, 4)), _ids(r, (3, 5), 10)], {},
                  (3, 5, 4)),
    "silu": (lambda r: [_ints(r, (3, 5))], {}, (3, 5)),
    "rsqrt": (lambda r: [_ints(r, (3, 5), 1, 50)], {}, (3, 5)),
    "div": (lambda r: [_ints(r, (3, 5)), _ints(r, (3, 5), 1, 9)], {},
            (3, 5)),
    "softmax": (lambda r: [_ints(r, (3, 7))], {}, (3, 7)),
    "rmsnorm": (lambda r: [_ints(r, (3, 4, 8)), _ints(r, (8,))],
                {"eps": 1e-5}, (3, 4, 8)),
    "layernorm": (lambda r: [_ints(r, (3, 4, 8)), _ints(r, (8,)),
                             _ints(r, (8,))],
                  {"eps": 1e-5, "norm": "layer"}, (3, 4, 8)),
    "gather": (lambda r: [_ints(r, (2, 3, 7)), _ids(r, (2, 3), 7)], {},
               (2, 3)),
    "attention": (lambda r: [_ints(r, (2, 4, 6, 8), -2, 3),
                             _ints(r, (2, 2, 6, 8), -2, 3),
                             _ints(r, (2, 2, 6, 8))],
                  {"causal": True}, (2, 4, 6, 8)),
    "ones": (lambda r: [], {}, (3, 2)),
    "relu_grad": (lambda r: [_ints(r, (3, 5)), _ints(r, (3, 5))], {},
                  (3, 5)),
    "gelu_grad": (lambda r: [_ints(r, (3, 5)), _ints(r, (3, 5))], {},
                  (3, 5)),
    "mul_grad": (lambda r: [_ints(r, (3, 5)), _ints(r, (3, 5))], {},
                 (3, 5)),
    "bcast": (lambda r: [_ints(r, (3, 4))], {"dim": 1}, (3, 5, 4)),
    "embed_grad": (lambda r: [_ints(r, (3, 5, 4)), _ids(r, (3, 5), 6)],
                   {}, (6, 4)),
    "silu_grad": (lambda r: [_ints(r, (3, 5)), _ints(r, (3, 5))], {},
                  (3, 5)),
    "softmax_grad": (lambda r: [_ints(r, (3, 5)), _ints(r, (3, 5))], {},
                     (3, 5)),
    "norm_grad_x": (lambda r: [_ints(r, (3, 4, 8)), _ints(r, (3, 4, 8)),
                               _ints(r, (8,))], {"eps": 1e-5}, (3, 4, 8)),
    "norm_grad_w": (lambda r: [_ints(r, (3, 4, 8)), _ints(r, (3, 4, 8))],
                    {"eps": 1e-5}, (8,)),
    "norm_grad_b": (lambda r: [_ints(r, (3, 4, 8))], {}, (8,)),
    "gather_grad": (lambda r: [_ints(r, (2, 3)), _ids(r, (2, 3), 7)], {},
                    (2, 3, 7)),
    "attn_grad_q": (lambda r: [_ints(r, (2, 4, 6, 8)),
                               _ints(r, (2, 4, 6, 8), -2, 3),
                               _ints(r, (2, 2, 6, 8), -2, 3),
                               _ints(r, (2, 2, 6, 8))],
                    {"causal": True}, (2, 4, 6, 8)),
}
CASES["attn_grad_k"] = CASES["attn_grad_v"] = (
    CASES["attn_grad_q"][0], {"causal": True}, (2, 2, 6, 8))


def _check(kind, got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, kind
    if kind in CLOSE:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=kind)
    else:
        np.testing.assert_array_equal(got, want, err_msg=kind)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_local_apply_matches_numpy(kind):
    make, attrs, out_shape = CASES[kind]
    ins = make(np.random.default_rng(0))
    dt = ops_np.result_dtype(kind, [x.dtype for x in ins])
    want = np.asarray(ops_np.local_apply(kind, np, ins, attrs,
                                         out_shape)).astype(dt)
    got = torch_ops.local_apply(kind, [torch.from_numpy(x) for x in ins],
                                attrs, out_shape, "cpu")
    _check(kind, got.to(torch_ops.torch_dtype(dt)), want)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_stacked_apply_matches_numpy(kind):
    make, attrs, out_shape = CASES[kind]
    rng = np.random.default_rng(1)
    n = 3
    rows = [make(rng) for _ in range(n)]
    ins = [np.stack([r[i] for r in rows]) for i in range(len(rows[0]))]
    dt = ops_np.result_dtype(kind, [x.dtype for x in ins] or [])
    want = ops_np.stacked_apply(kind, np, ins, attrs, out_shape, n)
    got = torch_ops.stacked_apply(kind, [torch.from_numpy(x) for x in ins],
                                  attrs, out_shape, n, "cpu")
    assert (got is None) == (want is None), kind
    if want is None:
        return
    _check(kind, got.to(torch_ops.torch_dtype(dt)),
           np.asarray(want).astype(dt))
    # row j of the stacked call is the local call on row j
    for j in range(n):
        one = torch_ops.local_apply(
            kind, [torch.from_numpy(r) for r in rows[j]], attrs, out_shape,
            "cpu")
        np.testing.assert_array_equal(got[j].numpy(), one.numpy(),
                                      err_msg=f"{kind} row {j}")


@pytest.mark.parametrize("kind", sorted(CASES))
def test_op_semantics_copy_matches_the_jax_package(kind):
    """The port's numpy copy, local and stacked, bit for bit and dtype for
    dtype against the JAX package's, on non-integer inputs too."""
    make, attrs, out_shape = CASES[kind]
    rng = np.random.default_rng(2)
    rows = [make(rng) for _ in range(3)]
    rows = [[x + rng.standard_normal(x.shape).astype(x.dtype) / 7
             if x.dtype == np.float32 else x for x in r] for r in rows]
    ins = [np.stack([r[i] for r in rows]) for i in range(len(rows[0]))]
    assert ops_copy.result_dtype(kind, [x.dtype for x in ins]) == \
        ops_np.result_dtype(kind, [x.dtype for x in ins])
    for got, want in (
            (ops_copy.local_apply(kind, np, rows[0], attrs, out_shape),
             ops_np.local_apply(kind, np, rows[0], attrs, out_shape)),
            (ops_copy.stacked_apply(kind, np, ins, attrs, out_shape, 3),
             ops_np.stacked_apply(kind, np, ins, attrs, out_shape, 3))):
        assert (got is None) == (want is None), kind
        if want is not None:
            got, want = np.asarray(got), np.asarray(want)
            assert got.dtype == want.dtype, kind
            np.testing.assert_array_equal(got, want, err_msg=kind)


def test_stacked_dot_with_a_vector_has_no_stacked_form():
    a, b = torch.ones(2, 3, 4), torch.ones(2, 4)
    assert torch_ops.stacked_apply("dot", [a, b], {}, (3,), 2) is None


def test_mixed_int_and_float_operands_promote_as_numpy():
    """numpy gives float64 for int32 + float32, torch float32: the port
    promotes as numpy does before it computes."""
    a = np.array([16777217, 3], np.int32)       # 2**24 + 1: not float32
    b = np.array([0.5, 0.25], np.float32)
    want = ops_np.local_apply("add", np, [a, b], {}, (2,))
    got = torch_ops.local_apply("add", [torch.from_numpy(a),
                                        torch.from_numpy(b)], {}, (2,))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_rows,vocab", [(200, 7), (1000, 50), (64, 64)])
def test_embed_grad_adds_duplicates_in_np_add_at_order(n_rows, vocab):
    """Float addition is not associative: with non-integer rows the sum
    over duplicate ids depends on its order.  The port adds them as
    ``np.add.at`` does, first occurrence first, bit for bit."""
    rng = np.random.default_rng(n_rows)
    ids = rng.integers(0, vocab, (n_rows,)).astype(np.int32)
    dy = rng.standard_normal((n_rows, 5)).astype(np.float32)
    want = np.zeros((vocab, 5), np.float32)
    np.add.at(want, ids, dy)
    got = torch_ops.local_apply(
        "embed_grad", [torch.from_numpy(dy), torch.from_numpy(ids)], {},
        (vocab, 5))
    np.testing.assert_array_equal(got.numpy(), want)
    # a reversed order gives other bits somewhere: the check can fail
    rev = np.zeros((vocab, 5), np.float32)
    np.add.at(rev, ids[::-1], dy[::-1])
    assert n_rows <= vocab or not np.array_equal(rev, want)
