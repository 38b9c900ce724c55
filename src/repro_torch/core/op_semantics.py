"""Local shard semantics of compute operators.

Progressive specialization (paper §5.3) turns every compute op into a
*device-local* computation over local shards: elementwise ops apply
pointwise, ``dot`` with a split contraction dim produces a Partial
summand, ``sum`` over a split dim produces a summand, and so on — the
annotation deduction rules (``core.graph.DEDUCTION_RULES``) guarantee
the local results compose back into the global value.

The kernels here are parameterized by the array namespace (``numpy`` for
the virtual-device simulator executor, ``jax.numpy`` for the shard_map
runtime) so both execution backends share ONE definition of what each
op computes — the basis of the differential bit-exactness tests.
"""

from __future__ import annotations

GELU_C = 0.7978845608028654  # sqrt(2/pi)


# kernels that compute through transcendentals (or true division) and
# therefore always produce floating-point outputs, regardless of input
# integerness — the dtype-widening set of ``result_dtype``
_FLOAT_KINDS = frozenset((
    "gelu", "gelu_grad", "scale", "silu", "silu_grad", "softmax",
    "softmax_grad", "rsqrt", "div", "rmsnorm", "layernorm",
    "norm_grad_x", "norm_grad_w", "norm_grad_b", "attention",
    "attn_grad_q", "attn_grad_k", "attn_grad_v",
))


def result_dtype(kind: str, in_dtypes):
    """The output dtype BOTH executors cast to: numpy promotion over the
    inputs, widened to floating for transcendental kernels (numpy would
    otherwise promote int inputs to float64 while jax stays in float32,
    silently diverging the executors)."""
    import numpy as np
    if kind == "ones":             # the autodiff gradient seed: no inputs
        return np.dtype(np.float32)
    if kind in ("embedding", "embed_grad", "gather", "gather_grad"):
        # integer indices must not promote the value dtype (numpy's
        # f32+int32 -> f64 would diverge from jax); the value operand is
        # the first input in all four kinds
        dt = np.dtype(in_dtypes[0])
        if kind in ("gather", "gather_grad") and \
                not np.issubdtype(dt, np.floating):
            dt = np.dtype(np.float32)
        return dt
    dt = np.result_type(*in_dtypes)
    if kind in _FLOAT_KINDS and not np.issubdtype(dt, np.floating):
        dt = np.dtype(np.float32)  # not result_type: int32+f32 -> f64
    return dt


def _softmax_lastdim(xp, x):
    """Max-subtracted softmax over the last axis (the same math
    ``jax.nn.softmax`` performs), in the input dtype."""
    m = xp.max(x, axis=-1, keepdims=True)
    e = xp.exp(x - m)
    return e / xp.sum(e, axis=-1, keepdims=True)


def _norm_stats(xp, x, attrs):
    """(normalized x̂ in float32, rsqrt factor r) for ``rmsnorm`` /
    ``layernorm`` and their VJPs — shared so forward and backward agree
    on the exact normalization math (mirrors ``models.layers``)."""
    import numpy as np
    xf = x.astype(np.float32)
    eps = np.float32(attrs.get("eps", 1e-5))
    if attrs.get("norm", "rms") == "layer":
        mu = xp.mean(xf, axis=-1, keepdims=True)
        xc = xf - mu
        var = xp.mean(xc * xc, axis=-1, keepdims=True)
        r = 1.0 / xp.sqrt(var + eps)
        return xc * r, r
    ms = xp.mean(xf * xf, axis=-1, keepdims=True)
    r = 1.0 / xp.sqrt(ms + eps)
    return xf * r, r


def _attn_probs(xp, q, k, attrs):
    """(probs float32, repeated K) of the attention composite — the
    reference math of ``kernels.ref.flash_attention_ref``, parameterized
    by the array namespace so both executors share it."""
    import numpy as np
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    rep = h // kh
    kq = xp.repeat(k, rep, axis=1)
    logits = xp.einsum("bhqd,bhkd->bhqk", q, kq).astype(np.float32)
    logits = logits / np.float32(np.sqrt(np.float32(d)))
    if attrs.get("causal", True):
        qi = np.arange(sq)
        ki = np.arange(sk)
        mask = xp.asarray(ki[None, :] <= qi[:, None])
        logits = xp.where(mask[None, None], logits, np.float32(-1e30))
    return _softmax_lastdim(xp, logits), kq


def _fold_gqa(xp, dkq, kh):
    """Sum a per-query-head (b, H, sk, d) gradient back onto the
    (b, K, sk, d) kv heads (``repeat``'s transpose)."""
    b, h, sk, d = dkq.shape
    rep = h // kh
    return xp.sum(xp.reshape(dkq, (b, kh, rep, sk, d)), axis=2)


def local_apply(kind: str, xp, ins, attrs, out_shape):
    """Apply compute op ``kind`` to device-local input shards.

    ``out_shape`` is the device-local output shape (needed by ``reshape``,
    whose local target shape is annotation-dependent).
    """
    if kind == "gelu":
        x = ins[0]
        return 0.5 * x * (1.0 + xp.tanh(GELU_C * (x + 0.044715 * x * x * x)))
    if kind == "relu":
        return xp.maximum(ins[0], 0)
    if kind == "scale":
        return ins[0] * attrs.get("factor", 1.0)
    if kind == "add":
        return ins[0] + ins[1]
    if kind == "mul":
        return ins[0] * ins[1]
    if kind == "dot":
        return xp.matmul(ins[0], ins[1])
    if kind == "sum":
        return xp.sum(ins[0], axis=attrs["dim"])
    if kind == "transpose":
        return xp.transpose(ins[0], attrs["perm"])
    if kind == "reshape":
        return xp.reshape(ins[0], out_shape)
    if kind == "embedding":
        table, ids = ins
        return xp.take(table, ids, axis=0)
    if kind == "silu":
        x = ins[0]
        return x / (1.0 + xp.exp(-x))
    if kind == "rsqrt":
        return 1.0 / xp.sqrt(ins[0])
    if kind == "div":
        return ins[0] / ins[1]
    if kind == "softmax":
        return _softmax_lastdim(xp, ins[0])
    if kind in ("rmsnorm", "layernorm"):
        x = ins[0]
        w = ins[1]
        xhat, _ = _norm_stats(xp, x, attrs)
        y = xhat.astype(x.dtype) * w
        if kind == "layernorm":
            y = y + ins[2]
        return y
    if kind == "gather":          # pick one element along the last axis
        x, ids = ins
        return xp.take_along_axis(x, ids[..., None], axis=-1)[..., 0]
    if kind == "attention":       # q (B,H,Sq,D); k/v (B,K,Sk,D), GQA
        q, k, v = ins
        probs, _ = _attn_probs(xp, q, k, attrs)
        rep = q.shape[1] // k.shape[1]
        vq = xp.repeat(v, rep, axis=1)
        return xp.einsum("bhqk,bhkd->bhqd", probs.astype(q.dtype), vq)
    # -- backward-only kernels (reverse-mode autodiff) ----------------------
    if kind == "ones":            # gradient seed dL/dL == 1
        return xp.ones(out_shape)
    if kind == "relu_grad":
        dy, x = ins
        return dy * (x > 0)
    if kind == "gelu_grad":
        dy, x = ins
        u = GELU_C * (x + 0.044715 * x * x * x)
        t = xp.tanh(u)
        du = GELU_C * (1.0 + 3 * 0.044715 * x * x)
        return dy * (0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du)
    if kind == "mul_grad":        # dy * other; linear in dy (Partial-safe)
        return ins[0] * ins[1]
    if kind == "bcast":           # VJP of sum: replicate along the new dim
        return xp.broadcast_to(xp.expand_dims(ins[0], attrs["dim"]),
                               out_shape)
    if kind == "embed_grad":      # VJP of embedding: scatter-add rows
        dy, ids = ins
        d = dy.shape[-1]
        dyf = xp.reshape(dy, (-1, d))
        idf = xp.reshape(ids, (-1,))
        buf = xp.zeros(out_shape, dy.dtype)
        if hasattr(buf, "at"):    # jax.numpy functional index update
            return buf.at[idf].add(dyf)
        import numpy as _np
        _np.add.at(buf, idf, dyf)
        return buf
    if kind == "silu_grad":
        dy, x = ins
        s = 1.0 / (1.0 + xp.exp(-x))
        return dy * (s * (1.0 + x * (1.0 - s)))
    if kind == "softmax_grad":    # dx = y * (dy - <dy, y>); linear in dy
        dy, y = ins
        return y * (dy - xp.sum(dy * y, axis=-1, keepdims=True))
    if kind == "norm_grad_x":     # VJP of rmsnorm/layernorm wrt x
        import numpy as np
        dy, x, w = ins
        xhat, r = _norm_stats(xp, x, attrs)
        dxhat = (dy * w).astype(np.float32)
        d = np.float32(x.shape[-1])
        if attrs.get("norm", "rms") == "layer":
            return r * (dxhat
                        - xp.mean(dxhat, axis=-1, keepdims=True)
                        - xhat * xp.mean(dxhat * xhat, axis=-1,
                                         keepdims=True))
        return r * dxhat - (xhat * r) * xp.sum(
            dxhat * xhat, axis=-1, keepdims=True) / d
    if kind == "norm_grad_w":     # dw = sum_lead(dy * x̂); linear in dy
        import numpy as np
        dy, x = ins
        xhat, _ = _norm_stats(xp, x, attrs)
        t = dy.astype(np.float32) * xhat
        return xp.sum(xp.reshape(t, (-1, t.shape[-1])), axis=0)
    if kind == "norm_grad_b":     # db = sum_lead(dy)
        dy = ins[0]
        return xp.sum(xp.reshape(dy, (-1, dy.shape[-1])), axis=0)
    if kind == "gather_grad":     # one-hot scatter along the last axis
        import numpy as np
        dy, ids = ins
        onehot = (xp.arange(out_shape[-1]) == ids[..., None])
        return onehot.astype(dy.dtype) * dy[..., None]
    if kind in ("attn_grad_q", "attn_grad_k", "attn_grad_v"):
        import numpy as np
        dy, q, k, v = ins
        probs, kq = _attn_probs(xp, q, k, attrs)
        kh = k.shape[1]
        rep = q.shape[1] // kh
        dyf = dy.astype(np.float32)
        if kind == "attn_grad_v":
            dvq = xp.einsum("bhqk,bhqd->bhkd", probs, dyf)
            return _fold_gqa(xp, dvq, kh)
        vq = xp.repeat(v, rep, axis=1).astype(np.float32)
        dp = xp.einsum("bhqd,bhkd->bhqk", dyf, vq)
        ds = probs * (dp - xp.sum(dp * probs, axis=-1, keepdims=True))
        scale = np.float32(1.0) / np.float32(np.sqrt(np.float32(q.shape[-1])))
        if kind == "attn_grad_q":
            return xp.einsum("bhqk,bhkd->bhqd",
                             ds, kq.astype(np.float32)) * scale
        dkq = xp.einsum("bhqk,bhqd->bhkd", ds, q.astype(np.float32)) * scale
        return _fold_gqa(xp, dkq, kh)
    raise NotImplementedError(f"no local semantics for op kind {kind!r}")


#: kinds whose local semantics are already pointwise / last-axis only,
#: so the stacked (n, *local) call IS the per-shard call, bit for bit
_STACK_TRANSPARENT = frozenset((
    "gelu", "relu", "scale", "add", "mul", "silu", "rsqrt", "div",
    "softmax", "gather", "relu_grad", "gelu_grad", "mul_grad",
    "silu_grad", "softmax_grad", "gather_grad",
))

#: kinds that fold the class axis into the batch axis and call the
#: plain local kernel once (batched einsums process each slice exactly
#: as the unbatched call would)
_STACK_BATCHFOLD = frozenset((
    "attention", "attn_grad_q", "attn_grad_k", "attn_grad_v",
))


def stacked_apply(kind: str, xp, ins, attrs, out_shape, n: int):
    """Apply ``kind`` to ``n`` same-shaped device shards at once.

    Every input of ``ins`` is the class-stacked buffer ``(n, *local)``
    (one row per device of a specialization class; ``core.lowered_ir``),
    ``out_shape`` the per-device local output shape.  Returns the
    stacked ``(n, *out_shape)`` result, or ``None`` when the kind has no
    vectorized form — the caller then falls back to the per-device loop.

    Bit-exactness contract: row ``j`` of the result must equal
    ``local_apply(kind, xp, [x[j] for x in ins], attrs, out_shape)``
    exactly.  Each adapter below only re-indexes axes (shifting them
    past the stack axis, folding it into a batch dim, or replicating a
    weight across rows); no reassociation of float reductions happens,
    because numpy applies the same last-axis / contraction loops per
    slice of a batched call.
    """
    if kind in _STACK_TRANSPARENT:
        return local_apply(kind, xp, ins, attrs, out_shape)
    if kind in _STACK_BATCHFOLD:
        b = ins[0].shape[1]
        folded = [xp.reshape(x, (-1,) + x.shape[2:]) for x in ins]
        y = local_apply(kind, xp, folded, attrs, None)
        return xp.reshape(y, (n, b) + y.shape[1:])
    if kind == "dot":
        a, b = ins
        if a.ndim < 3 or b.ndim < 3:
            return None           # 1-D operand: matmul semantics differ
        if a.ndim > b.ndim:
            b = xp.reshape(b, (n,) + (1,) * (a.ndim - b.ndim)
                           + b.shape[1:])
        elif b.ndim > a.ndim:
            a = xp.reshape(a, (n,) + (1,) * (b.ndim - a.ndim)
                           + a.shape[1:])
        return xp.matmul(a, b)
    if kind == "sum":
        d = attrs["dim"]
        return xp.sum(ins[0], axis=(d + 1 if d >= 0 else d))
    if kind == "transpose":
        return xp.transpose(ins[0],
                            (0,) + tuple(p + 1 for p in attrs["perm"]))
    if kind == "reshape":
        return xp.reshape(ins[0], (n,) + tuple(out_shape))
    if kind == "bcast":
        d = attrs["dim"]
        return xp.broadcast_to(
            xp.expand_dims(ins[0], d + 1 if d >= 0 else d),
            (n,) + tuple(out_shape))
    if kind == "ones":
        return xp.ones((n,) + tuple(out_shape))
    if kind == "embedding":
        table, ids = ins
        rows = xp.arange(n)[:, None]
        picked = table[rows, xp.reshape(ids, (n, -1))]
        return xp.reshape(picked, (n,) + tuple(out_shape))
    if kind == "embed_grad":
        import numpy as _np
        dy, ids = ins
        d = dy.shape[-1]
        dyf = xp.reshape(dy, (n, -1, d))
        idf = xp.reshape(ids, (n, -1))
        buf = xp.zeros((n,) + tuple(out_shape), dy.dtype)
        _np.add.at(buf, (xp.arange(n)[:, None], idf), dyf)
        return buf
    if kind in ("rmsnorm", "layernorm"):
        x, w = ins[0], ins[1]
        wr = xp.reshape(w, (n,) + (1,) * (x.ndim - 2) + w.shape[1:])
        xhat, _ = _norm_stats(xp, x, attrs)
        y = xhat.astype(x.dtype) * wr
        if kind == "layernorm":
            y = y + xp.reshape(ins[2],
                               (n,) + (1,) * (x.ndim - 2) + w.shape[1:])
        return y
    if kind == "norm_grad_x":
        import numpy as np
        dy, x, w = ins
        wr = xp.reshape(w, (n,) + (1,) * (x.ndim - 2) + w.shape[1:])
        xhat, r = _norm_stats(xp, x, attrs)
        dxhat = (dy * wr).astype(np.float32)
        d = np.float32(x.shape[-1])
        if attrs.get("norm", "rms") == "layer":
            return r * (dxhat
                        - xp.mean(dxhat, axis=-1, keepdims=True)
                        - xhat * xp.mean(dxhat * xhat, axis=-1,
                                         keepdims=True))
        return r * dxhat - (xhat * r) * xp.sum(
            dxhat * xhat, axis=-1, keepdims=True) / d
    if kind == "norm_grad_w":
        import numpy as np
        dy, x = ins
        xhat, _ = _norm_stats(xp, x, attrs)
        t = dy.astype(np.float32) * xhat
        return xp.sum(xp.reshape(t, (n, -1, t.shape[-1])), axis=1)
    if kind == "norm_grad_b":
        dy = ins[0]
        return xp.sum(xp.reshape(dy, (n, -1, dy.shape[-1])), axis=1)
    return None


# ---------------------------------------------------------------------------
# microbatch role propagation (pipeline schedules, paper §5.4)
# ---------------------------------------------------------------------------
#
# Splitting the batch into microbatches is itself an SPMD-style split —
# along *time* instead of devices.  Every tensor relates to the
# microbatch axis in one of the DS ways (reusing the annotation dim
# vocabulary, ``annotations.DUP``/``PARTIAL``):
#
#   role >= 0   Split: the tensor's dim ``role`` is the batch dim; each
#               microbatch computes a 1/m slice of it,
#   role == DUP       the tensor is microbatch-invariant (parameters),
#   role == PARTIAL   each microbatch holds a summand (a loss or grad
#               accumulated across microbatches).
#
# ``microbatch_role`` is the per-op propagation rule — the same table
# shape as DEDUCTION_RULES, one tier up.  It is what lets Session.run
# reduce per-microbatch outputs correctly (sum Partial, concat Split,
# take-one Duplicate) and lets the micro-plan compiler scale shapes.

MB_DUP = -1       # mirrors annotations.DUP
MB_PARTIAL = -2   # mirrors annotations.PARTIAL


class MicrobatchError(ValueError):
    """The graph cannot be split along the batch dim at this op."""


def cotangent_role(role: int) -> int:
    """The microbatch role of a tensor's GRADIENT: a per-microbatch
    slice's grad is a per-microbatch slice; a microbatch-invariant
    tensor (parameters) accumulates per-microbatch grad summands
    (Partial); a Partial tensor (the loss) receives an invariant seed.
    The same Duplicate <-> Partial duality as annotation cotangents,
    one tier up."""
    if role == MB_DUP:
        return MB_PARTIAL
    if role == MB_PARTIAL:
        return MB_DUP
    return role


def microbatch_role(kind: str, in_roles, attrs, in_ndims) -> int:
    """Propagate the microbatch role through one compute op.

    ``in_roles`` follow the DS dim vocabulary above; ``in_ndims`` are the
    input ranks (the Dot rule needs them).  Raises
    :class:`MicrobatchError` where no per-microbatch computation exists
    (nonlinearity over Partial, Split mixed with full-shape Duplicate...).
    """
    if kind in ("gelu", "relu", "silu", "rsqrt", "softmax"):
        (r,) = in_roles
        if r == MB_PARTIAL:
            raise MicrobatchError(
                f"{kind} is nonlinear; cannot apply it per-microbatch to "
                f"an accumulated (Partial) value")
        if kind == "softmax" and r == in_ndims[0] - 1:
            raise MicrobatchError(
                "softmax over the microbatch (batch) dim; per-microbatch "
                "slices cannot reproduce the full normalization")
        return r
    if kind == "div":
        a, b = in_roles
        if b == MB_PARTIAL:
            raise MicrobatchError(
                "div by a microbatch-Partial value is nonlinear in the "
                "microbatch sum")
        if a == b:
            return a
        if a == MB_PARTIAL and b == MB_DUP:
            return MB_PARTIAL     # (sum_i x_i) / y == sum_i (x_i / y)
        raise MicrobatchError(
            f"div operands have incompatible microbatch roles ({a} vs {b})")
    if kind in ("rmsnorm", "layernorm"):
        r = in_roles[0]
        if r == MB_PARTIAL:
            raise MicrobatchError(
                f"{kind} is nonlinear; cannot normalize an accumulated "
                f"(Partial) value per-microbatch")
        if r == in_ndims[0] - 1:
            raise MicrobatchError(
                f"{kind} normalizes the microbatch (batch) dim")
        if any(x != MB_DUP for x in in_roles[1:]):
            raise MicrobatchError(
                f"{kind} weights must be microbatch-invariant")
        return r
    if kind == "gather":
        rx, ri = in_roles
        if ri == MB_PARTIAL:
            raise MicrobatchError("gather indices cannot be Partial")
        if rx >= 0 and rx == in_ndims[0] - 1:
            raise MicrobatchError(
                "gather's indexed (last) dim is the microbatch dim")
        if rx == ri:
            return rx
        if rx == MB_DUP and ri >= 0:
            return ri             # per-microbatch index slice
        if rx == MB_PARTIAL and ri == MB_DUP:
            return MB_PARTIAL     # gather is linear in x
        raise MicrobatchError(
            f"gather operand microbatch roles ({rx}, {ri}) are unsupported")
    if kind == "attention":
        rq = in_roles[0]
        if any(r != rq for r in in_roles):
            raise MicrobatchError(
                "attention operands must share one microbatch role")
        if rq == MB_DUP or rq == 0:
            return rq             # batch dim slices independently
        raise MicrobatchError(
            f"attention microbatch role {rq} is unsupported (only the "
            f"batch dim 0 slices through causal attention)")
    if kind == "scale":           # linear: every role passes through
        return in_roles[0]
    if kind in ("add", "mul"):
        a, b = in_roles
        if a == b:
            if kind == "mul" and a == MB_PARTIAL:
                raise MicrobatchError(
                    "mul of two microbatch-Partial values is nonlinear "
                    "in the microbatch sum")
            return a
        if kind == "mul" and {a, b} == {MB_PARTIAL, MB_DUP}:
            return MB_PARTIAL     # (sum_i x_i) * y == sum_i (x_i * y)
        raise MicrobatchError(
            f"{kind} operands have incompatible microbatch roles "
            f"({a} vs {b}); a per-microbatch slice cannot combine with a "
            f"full-batch operand")
    if kind == "dot":
        rx, rw = in_roles
        x_ndim = in_ndims[0]
        if rx == MB_PARTIAL and rw == MB_PARTIAL:
            raise MicrobatchError("dot of two microbatch-Partial values")
        if rx == MB_PARTIAL or rw == MB_PARTIAL:
            other = rw if rx == MB_PARTIAL else rx
            if other != MB_DUP:
                raise MicrobatchError(
                    "dot mixes a microbatch-Partial operand with a "
                    "per-microbatch slice")
            return MB_PARTIAL     # dot is linear in either operand
        if rx == MB_DUP and rw == MB_DUP:
            return MB_DUP
        if rx >= 0 and rw == MB_DUP:
            if rx == x_ndim - 1:
                raise MicrobatchError(
                    "X's contraction dim is the batch dim but W is "
                    "microbatch-invariant; shapes cannot match")
            return rx             # batch/m dims pass through
        if rx == x_ndim - 1 and rw == 0:
            return MB_PARTIAL     # contraction split over microbatches
        if rx == MB_DUP and rw == 1:
            return x_ndim - 1
        raise MicrobatchError(
            f"dot operand microbatch roles ({rx}, {rw}) are unsupported")
    if kind == "sum":
        (r,) = in_roles
        dim = attrs["dim"]
        if r == dim:
            return MB_PARTIAL     # reduced batch dim -> accumulate
        if r >= 0:
            return r - 1 if r > dim else r
        return r                  # DUP / PARTIAL (linear) pass through
    if kind == "transpose":
        (r,) = in_roles
        if r < 0:
            return r
        inv = {old: new for new, old in enumerate(attrs["perm"])}
        return inv[r]
    if kind == "reshape":
        (r,) = in_roles
        return r                  # mapped by the caller (needs shapes)
    if kind == "embedding":
        rt, ri = in_roles
        if rt == MB_DUP and ri == MB_DUP:
            return MB_DUP
        if rt == MB_DUP and ri >= 0:
            return ri             # per-microbatch token slice
        raise MicrobatchError(
            f"embedding operand microbatch roles ({rt}, {ri}) are "
            f"unsupported")
    if kind == "ones":
        return MB_DUP             # the gradient seed is batch-invariant
    if kind in ("relu_grad", "gelu_grad", "mul_grad", "silu_grad",
                "softmax_grad"):
        dy, x = in_roles
        if dy == x:
            return dy
        if dy == MB_PARTIAL and x == MB_DUP:
            return MB_PARTIAL     # linear in dy
        raise MicrobatchError(
            f"{kind} operands have incompatible microbatch roles "
            f"({dy} vs {x})")
    if kind in ("norm_grad_x", "attn_grad_q", "attn_grad_k", "attn_grad_v"):
        dy = in_roles[0]
        rest = in_roles[1:]
        if all(r == dy for r in rest) or (
                dy == MB_PARTIAL and all(r == MB_DUP for r in rest)):
            # norm_grad_x carries a microbatch-invariant weight operand
            if kind == "norm_grad_x" and in_roles[2] not in (dy, MB_DUP):
                raise MicrobatchError(
                    "norm_grad_x weight must be microbatch-invariant")
            return dy             # linear in dy
        if kind == "norm_grad_x" and in_roles[1] == dy \
                and in_roles[2] == MB_DUP:
            return dy
        raise MicrobatchError(
            f"{kind} operands have incompatible microbatch roles "
            f"{in_roles}")
    if kind in ("norm_grad_w", "norm_grad_b"):
        dy = in_roles[0]
        if kind == "norm_grad_w" and in_roles[1] not in (dy, MB_DUP):
            raise MicrobatchError(
                "norm_grad_w activation role must match dy")
        if dy >= 0 or dy == MB_PARTIAL:
            return MB_PARTIAL     # per-microbatch summand of the sum_lead
        return MB_DUP
    if kind == "gather_grad":
        dy, ri = in_roles
        if ri == MB_PARTIAL:
            raise MicrobatchError("gather_grad indices cannot be Partial")
        if dy == ri or (dy == MB_PARTIAL and ri == MB_DUP):
            return dy             # scatter over leading dims; linear in dy
        raise MicrobatchError(
            f"gather_grad operand microbatch roles ({dy}, {ri}) are "
            f"unsupported")
    if kind == "bcast":
        (r,) = in_roles
        if r < 0:
            return r
        return r + 1 if r >= attrs["dim"] else r
    if kind == "embed_grad":
        dy, _ = in_roles
        if dy >= 0:
            return MB_PARTIAL     # scatter-add over the batch slice
        return dy
    raise NotImplementedError(f"no microbatch rule for op kind {kind!r}")


def flops(kind: str, in_shapes, out_shape, attrs) -> int:
    """Analytic FLOP count of one (global) compute op — the compute term
    of the roofline estimate attached to compiled plans."""
    import math
    numel = math.prod(out_shape) if out_shape else 0
    if kind == "dot":
        k = in_shapes[0][-1]
        return 2 * numel * k
    if kind == "sum":
        return math.prod(in_shapes[0])
    if kind in ("gelu",):
        return 8 * numel
    if kind in ("gelu_grad",):
        return 14 * numel         # tanh + polynomial derivative terms
    if kind in ("relu", "scale", "add", "mul", "mul_grad", "relu_grad",
                "div"):
        return numel
    if kind == "embed_grad":
        return math.prod(in_shapes[0])  # one add per dy element
    if kind in ("silu", "softmax_grad"):
        return 4 * numel
    if kind == "silu_grad":
        return 6 * numel
    if kind == "rsqrt":
        return 2 * numel
    if kind == "softmax":
        return 5 * numel              # max, sub, exp, sum, div
    if kind == "rmsnorm":
        return 4 * numel
    if kind == "layernorm":
        return 6 * numel
    if kind == "norm_grad_x":
        return 10 * numel             # recompute x̂ + two row reductions
    if kind == "norm_grad_w":
        return 3 * math.prod(in_shapes[0])
    if kind == "norm_grad_b":
        return math.prod(in_shapes[0])
    if kind == "gather_grad":
        return numel                  # one-hot select per output element
    if kind in ("attention", "attn_grad_q", "attn_grad_k", "attn_grad_v"):
        # q (B,H,Sq,D); k/v (B,K,Sk,D).  QK^T and PV are 2*B*H*Sq*Sk*D
        # each; softmax ~5*B*H*Sq*Sk; grads recompute probs + two more
        # score-shaped matmuls
        qs = in_shapes[0] if kind == "attention" else in_shapes[1]
        ks = in_shapes[1] if kind == "attention" else in_shapes[2]
        b, h, sq, d = qs
        sk = ks[2]
        scores = b * h * sq * sk
        mm = 2 * scores * d
        if kind == "attention":
            return 2 * mm + 5 * scores
        return 4 * mm + 7 * scores
    # transpose / reshape / bcast / embedding / ones / gather move data
    return 0
