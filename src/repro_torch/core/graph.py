"""User-facing computation graph with HSPMD annotation deduction (paper §5.1-5.2).

The user writes a *single-device-view* program; leaf operators
(placeholders, parameters) and explicit :class:`CommOp` nodes carry
annotations — every other tensor's annotation is **deduced**:

* ``DG Union`` / ``HSize`` unification converts all inputs to the largest
  HSize (paper Fig 10) and requires aligned DG unions afterwards;
* per-subgroup ``DS`` deduction mirrors classical SPMD rules (the 3D x 2D
  Dot table of Fig 11 is implemented verbatim);
* ``HDim`` deduction follows the same rule table one level up.

Tensors may carry *multiple* annotations simultaneously (paper §6.1): all
deduction runs synchronously per annotation index, producing one annotated
graph per parallel strategy out of a single user graph.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence

from .annotations import DG, DS, DUP, HSPMD, PARTIAL
from .symbolic import Dim


class DeductionError(ValueError):
    pass


class GradError(ValueError):
    """Reverse-mode autodiff cannot differentiate this graph."""


@dataclass
class Tensor:
    name: str
    shape: tuple[Dim, ...]
    annots: list[HSPMD] = field(default_factory=list)
    producer: "Op | None" = None

    @property
    def annot(self) -> HSPMD:
        if not self.annots:
            raise DeductionError(f"tensor {self.name!r} has no annotation")
        return self.annots[0]

    @property
    def n_strategies(self) -> int:
        return len(self.annots)

    def __repr__(self):
        return f"Tensor({self.name}, {self.shape}, {len(self.annots)} annot(s))"


@dataclass
class Op:
    kind: str
    inputs: list[Tensor]
    outputs: list[Tensor]
    attrs: dict = field(default_factory=dict)

    def __repr__(self):
        ins = ",".join(t.name for t in self.inputs)
        outs = ",".join(t.name for t in self.outputs)
        return f"Op<{self.kind}>({ins} -> {outs})"


# ---------------------------------------------------------------------------
# HSize / DG Union conversion (paper Fig 10)
# ---------------------------------------------------------------------------

def convert_hsize(annot: HSPMD, hsize: int) -> HSPMD:
    """Losslessly re-express ``annot`` with a larger HSize by splitting the
    outermost DS entry across new subgroups (semantic equivalence is
    preserved: same device -> shard mapping)."""
    if annot.hsize == hsize:
        return annot
    if annot.hsize != 1:
        raise DeductionError(
            f"can only convert HSize=1 annotations (got {annot.hsize} -> {hsize})")
    ds, dg = annot.dss[0], annot.dgs[0]
    if not ds.entries:
        raise DeductionError("cannot split an un-sharded single-device annot")
    d0, n0 = ds.entries[0]
    if n0 % hsize != 0:
        raise DeductionError(
            f"outermost entry {d0}:{n0} not divisible by HSize {hsize}")
    sub_n = n0 // hsize
    rest = ds.entries[1:]
    sub_entries = ([(d0, sub_n)] if sub_n > 1 else []) + list(rest)
    sub_ds = DS(sub_entries)
    per = len(dg) // hsize
    dgs = [dg.devices[i * per:(i + 1) * per] for i in range(hsize)]
    return HSPMD(dgs, [sub_ds] * hsize, hdim=d0)


def unify_inputs(annots: list[HSPMD]) -> list[HSPMD]:
    """Convert all input annotations to the largest HSize (Fig 10) and
    verify the DG unions align."""
    target = max(a.hsize for a in annots)
    out = [convert_hsize(a, target) if a.hsize < target else a for a in annots]
    base = out[0]
    for a in out[1:]:
        if not a.same_dg_union(base):
            raise DeductionError(
                "DG unions do not align after HSize conversion; insert a "
                "CommOp to reshard (paper §5.2)")
    return out


# ---------------------------------------------------------------------------
# per-op deduction rules
# ---------------------------------------------------------------------------

def _deduce_elementwise(ins: list[HSPMD], shapes) -> HSPMD:
    u = unify_inputs(ins)
    base = u[0]
    for a in u[1:]:
        if not (a.same_ds_union(base) and a.hdim == base.hdim
                and a.hsplits == base.hsplits):
            raise DeductionError(
                "elementwise operands must share sharding; insert CommOp")
    return base


def _entries_from_coords(n_dev: int, coords: "dict[int, list[int]]") -> DS:
    """Reconstruct an ordered DS from per-device output coordinates.

    ``coords[d][p]`` is device position ``p``'s shard coordinate along
    output entry ``d`` (Split dim, PARTIAL, or DUP).  A valid DS is a
    mixed-radix decomposition of ``p``, so each entry's stride is the
    smallest position that bumps ONLY that coordinate; ordering entries
    by descending stride and re-checking every position either recovers
    the unique decomposition or proves none exists (interleaved
    coordinates — not representable; the caller must insert a CommOp)."""
    dims = {d: max(c) + 1 for d, c in coords.items() if max(c) > 0}
    ranked = []
    for d, n in dims.items():
        stride = next(
            (p for p in range(1, n_dev)
             if coords[d][p] == 1
             and all(coords[e][p] == 0 for e in dims if e != d)), None)
        if stride is None:
            raise DeductionError(
                "operand shardings interleave; insert CommOp")
        ranked.append((stride, d, n))
    ranked.sort(key=lambda t: -t[0])
    ds = DS([(d, n) for _, d, n in ranked])
    if ds.num_devices != n_dev:
        raise DeductionError(
            "operand shardings interleave; insert CommOp")
    for p in range(n_dev):
        c = ds.coords(p)
        for d in dims:
            if c.get(d, 0) != coords[d][p]:
                raise DeductionError(
                    "operand shardings interleave; insert CommOp")
    return ds


def _dot_ds(x: DS, w: DS, x_ndim: int) -> DS:
    """Fig 11 (left): DS deduction for Dot(X[..., k], W[k, n]).

    Split on X's batch/m dims passes through; split on W's n dim becomes
    the output's last dim; matched contraction splits turn into Partial;
    Duplicate absorbs the rest.  The output's entry ORDER is recovered
    from the two operands' device->coordinate decompositions (not a
    canonical batch/col/partial ordering): the order fixes which devices
    share a summand group, and e.g. the ``dw = x^T @ dy`` dots of the
    backward pass carry their contraction split OUTERMOST."""
    n_dev = x.num_devices
    if w.num_devices != n_dev:
        raise DeductionError("operand subgroups have different device counts")
    kx = x.get(x_ndim - 1)          # X contraction split
    kw = w.get(0)                   # W contraction split
    if kx != kw:
        raise DeductionError(
            f"contraction dim split mismatch ({kx} vs {kw}); insert CommOp")
    try:
        xp, wp = x.get(PARTIAL), w.get(PARTIAL)
        coords: dict[int, list[int]] = {d: [] for d in range(x_ndim)}
        coords[PARTIAL] = []
        dup_seen: dict[tuple, int] = {}
        coords[DUP] = []
        for p in range(n_dev):
            cx, cw = x.coords(p), w.coords(p)
            ck_x = cx.get(x_ndim - 1, 0)
            ck_w = cw.get(0, 0)
            if ck_x != ck_w:
                raise DeductionError(
                    "contraction chunks pair different shards across "
                    "devices")
            for d in range(x_ndim - 1):
                coords[d].append(cx.get(d, 0))
            coords[x_ndim - 1].append(cw.get(1, 0))
            # summand id: contraction chunk x pre-existing Partial coords
            coords[PARTIAL].append(
                (ck_x * xp + cx.get(PARTIAL, 0)) * wp + cw.get(PARTIAL, 0))
            key = tuple(coords[d][p] for d in range(x_ndim)) \
                + (coords[PARTIAL][p],)
            coords[DUP].append(dup_seen.setdefault(key, 0))
            dup_seen[key] += 1
        return _entries_from_coords(n_dev, coords)
    except DeductionError:
        # count-based Fig 11 fallback for layouts whose decompositions
        # don't pair positionally (symbolic placements that deduce but
        # never execute locally): batch splits, then col, then Partial
        entries: list[tuple[int, int]] = []
        for d in range(x_ndim - 1):
            n = x.get(d)
            if n > 1:
                entries.append((d, n))
        if w.get(1) > 1:
            entries.append((x_ndim - 1, w.get(1)))
        partial = x.get(PARTIAL) * w.get(PARTIAL) * kx
        if partial > 1:
            entries.append((PARTIAL, partial))
        used = 1
        for _, n in entries:
            used *= n
        if n_dev % used != 0:
            raise DeductionError(
                f"inconsistent sharding: {used} does not divide {n_dev}")
        if n_dev // used > 1:
            entries.append((DUP, n_dev // used))
        return DS(entries)


def _dot_hdim(x_hdim: int, w_hdim: int, x_ndim: int) -> int:
    """Fig 11 (right): HDim deduction for Dot."""
    if x_hdim == PARTIAL or w_hdim == PARTIAL:
        return PARTIAL
    if x_hdim == x_ndim - 1 or w_hdim == 0:
        # contraction dim split across subgroups (must match on both sides)
        if (x_hdim == x_ndim - 1) != (w_hdim == 0):
            raise DeductionError("top-tier contraction split must match; "
                                 "insert CommOp")
        return PARTIAL
    if x_hdim >= 0:
        if w_hdim >= 0:
            raise DeductionError("both operands top-split on non-contraction "
                                 "dims; insert CommOp")
        return x_hdim
    if w_hdim == 1:
        return x_ndim - 1
    return DUP


def _deduce_dot(ins: list[HSPMD], shapes) -> HSPMD:
    x_ndim = len(shapes[0])
    if len(shapes[1]) != 2:
        raise DeductionError("Dot expects a 2D weight operand")
    xa, wa = unify_inputs(ins)
    dss = [_dot_ds(xs, ws, x_ndim) for xs, ws in zip(xa.dss, wa.dss)]
    hdim = _dot_hdim(xa.hdim, wa.hdim, x_ndim)
    hsplits = xa.hsplits if (xa.hdim == hdim and xa.hsplits) else None
    return HSPMD(xa.dgs, dss, hdim=hdim, hsplits=hsplits)


def _deduce_sum(ins: list[HSPMD], shapes, dim: int) -> HSPMD:
    (a,) = ins
    ndim = len(shapes[0])
    dss = []
    for ds in a.dss:
        # entry ORDER is the device -> shard decomposition, so the
        # reduced dim's split becomes Partial IN PLACE (the device's
        # former shard coordinate is now its summand id) — appending it
        # at the end would pair devices with the wrong summand groups
        entries: list[tuple[int, int]] = []
        for d, n in ds.entries:
            if d == dim or d == PARTIAL:
                if entries and entries[-1][0] == PARTIAL:
                    entries[-1] = (PARTIAL, entries[-1][1] * n)
                else:
                    entries.append((PARTIAL, n))
            elif d >= 0:
                entries.append((d - 1 if d > dim else d, n))
            else:
                entries.append((DUP, n))
        if sum(1 for d, _ in entries if d == PARTIAL) > 1:
            raise DeductionError(
                "sum produces non-adjacent Partial entries (existing "
                "Partial + reduced split); insert CommOp to reduce first")
        dss.append(DS(entries))
    if a.hdim == dim:
        hdim = PARTIAL
    elif a.hdim > dim:
        hdim = a.hdim - 1
    else:
        hdim = a.hdim
    return HSPMD(a.dgs, dss, hdim=hdim,
                 hsplits=a.hsplits if hdim == a.hdim else None)


def _deduce_transpose(ins: list[HSPMD], shapes, perm) -> HSPMD:
    """Sharded dims follow their tensor dims through the permutation."""
    (a,) = ins
    inv = {old: new for new, old in enumerate(perm)}
    dss = []
    for ds in a.dss:
        dss.append(DS([(inv[d] if d >= 0 else d, n) for d, n in ds.entries]))
    hdim = inv[a.hdim] if a.hdim >= 0 else a.hdim
    return HSPMD(a.dgs, dss, hdim=hdim, hsplits=a.hsplits)


def _deduce_reshape(ins: list[HSPMD], shapes, new_shape) -> HSPMD:
    """Paper §5.2: Reshape has specialized deduction.  Supported cases:
    every split dim must map to a dim of the new shape whose size is a
    multiple of the shard count and whose position is unambiguous
    (leading-dims product preserved); otherwise the user must insert a
    CommOp to replicate first."""
    (a,) = ins
    old_shape = shapes[0]

    from .symbolic import dim_multiple_of, dims_equal, prod_dims

    def map_dim(d: int) -> int:
        # a dim maps if the product of dims before it is preserved
        # (symbolic dims compare as canonicalized products)
        before = prod_dims(old_shape[:d])
        acc: Dim = 1
        for nd, size in enumerate(new_shape):
            if dims_equal(acc, before):
                return nd
            acc = prod_dims((acc, size))
        raise DeductionError(
            f"reshape moves sharded dim {d}; insert CommOp to replicate")

    dss = []
    for ds in a.dss:
        entries = []
        for d, n in ds.entries:
            if d >= 0:
                nd = map_dim(d)
                # symbolic sizes defer divisibility to bind time
                if dim_multiple_of(new_shape[nd], n) is False:
                    raise DeductionError(
                        f"reshaped dim {nd} size {new_shape[nd]} not "
                        f"divisible by {n} shards")
                entries.append((nd, n))
            else:
                entries.append((d, n))
        dss.append(DS(entries))
    hdim = map_dim(a.hdim) if a.hdim >= 0 else a.hdim
    return HSPMD(a.dgs, dss, hdim=hdim, hsplits=a.hsplits)


def _deduce_linear_grad(ins: list[HSPMD], shapes) -> HSPMD:
    """Elementwise deduction for ``x_grad``-style kernels (``relu_grad``,
    ``gelu_grad``, ``mul``'s backward uses): the FIRST operand (the
    upstream cotangent) may be Partial — the kernel is linear in it, so
    ``(sum_i dy_i) * mask == sum_i (dy_i * mask)`` and the Partial
    degree passes through.  Split dims must still agree."""
    u = unify_inputs(ins)
    dy = u[0]
    for a in u[1:]:
        for ds_dy, ds_a in zip(dy.dss, a.dss):
            if ds_a.has_partial:
                raise DeductionError(
                    "mask operand of a grad kernel is Partial; insert "
                    "CommOp to reduce it first")
            if ({d: n for d, n in ds_a.entries if d >= 0}
                    != {d: n for d, n in ds_dy.entries if d >= 0}):
                raise DeductionError(
                    "grad kernel operands have mismatched split dims; "
                    "insert CommOp")
    return dy


def _deduce_bcast(ins: list[HSPMD], shapes, dim: int) -> HSPMD:
    """Inverse of ``sum``'s dim bookkeeping: the new dim is inserted at
    ``dim`` (unsharded); split dims at or after it shift up.  Duplicate
    and Partial pass through (broadcast is linear)."""
    (a,) = ins
    dss = []
    for ds in a.dss:
        entries = []
        for d, n in ds.entries:
            if d >= dim:
                entries.append((d + 1, n))
            else:
                entries.append((d, n))
        dss.append(DS(entries))
    hdim = a.hdim + 1 if a.hdim >= dim else a.hdim
    return HSPMD(a.dgs, dss, hdim=hdim,
                 hsplits=a.hsplits if hdim == a.hdim else None)


def _deduce_embedding(ins: list[HSPMD], shapes) -> HSPMD:
    """Embedding lookup ``out[b..., :] = table[ids[b...], :]``.

    Indices are global, so the vocab dim (table dim 0) must not be
    split (insert a CommOp to replicate first); a split on the feature
    dim (table dim 1) becomes the output's last dim; ids splits pass
    through; the lookup is linear in the table, so a Partial table
    yields a Partial output, while Partial *indices* are meaningless.
    """
    ta, ia = unify_inputs(ins)
    ids_ndim = len(shapes[1])
    dss = []
    for ts, is_ in zip(ta.dss, ia.dss):
        if ts.get(0) > 1:
            raise DeductionError(
                "embedding table split along the vocab dim; insert a "
                "CommOp to replicate (indices are global)")
        if is_.get(PARTIAL) > 1:
            raise DeductionError("embedding indices cannot be Partial")
        entries: list[tuple[int, int]] = []
        for d in range(ids_ndim):
            n = is_.get(d)
            if n > 1:
                entries.append((d, n))
        n_split = ts.get(1)
        if n_split > 1:
            entries.append((ids_ndim, n_split))
        partial = ts.get(PARTIAL)
        if partial > 1:
            entries.append((PARTIAL, partial))
        n_dev = is_.num_devices
        used = 1
        for _, n in entries:
            used *= n
        if n_dev % used != 0:
            raise DeductionError(
                f"inconsistent embedding sharding: {used} does not "
                f"divide {n_dev}")
        if n_dev // used > 1:
            entries.append((DUP, n_dev // used))
        dss.append(DS(entries))
    if ia.hdim == PARTIAL:
        raise DeductionError("embedding indices cannot be Partial")
    if ia.hdim >= 0:
        if ta.hdim not in (DUP, PARTIAL):
            raise DeductionError(
                "both embedding operands top-split; insert CommOp")
        hdim = ia.hdim
    elif ta.hdim == 1:
        hdim = ids_ndim
    elif ta.hdim == PARTIAL:
        hdim = PARTIAL
    elif ta.hdim == 0:
        raise DeductionError(
            "embedding table top-split along the vocab dim; insert CommOp")
    else:
        hdim = DUP
    return HSPMD(ia.dgs, dss, hdim=hdim,
                 hsplits=ia.hsplits if hdim == ia.hdim else None)


def _deduce_embed_grad(ins: list[HSPMD], shapes) -> HSPMD:
    """VJP of embedding wrt the table: scatter-add of ``dy`` rows at
    ``ids``.  Batch splits collapse to Partial (each device scatters its
    slice of rows into a full-vocab buffer); a split feature dim maps to
    out dim 1; ids splits must match dy's batch splits."""
    da, ia = unify_inputs(ins)
    dy_ndim = len(shapes[0])
    dss = []
    for ds_, is_ in zip(da.dss, ia.dss):
        partial = ds_.get(PARTIAL)
        entries: list[tuple[int, int]] = []
        for d, n in ds_.entries:
            if d == dy_ndim - 1:
                entries.append((1, n))
            elif d >= 0:
                if is_.get(d) != n:
                    raise DeductionError(
                        f"embed_grad: dy batch dim {d} split {n} does not "
                        f"match ids split {is_.get(d)}")
                partial *= n
        if partial > 1:
            entries.append((PARTIAL, partial))
        n_dev = ds_.num_devices
        used = 1
        for _, n in entries:
            used *= n
        if n_dev % used != 0:
            raise DeductionError(
                f"inconsistent embed_grad sharding: {used} does not "
                f"divide {n_dev}")
        if n_dev // used > 1:
            entries.append((DUP, n_dev // used))
        dss.append(DS(entries))
    if da.hdim == dy_ndim - 1:
        hdim = 1
    elif da.hdim >= 0:
        hdim = PARTIAL
    else:
        hdim = da.hdim
    return HSPMD(da.dgs, dss, hdim=hdim)


def _deduce_softmax(ins: list[HSPMD], shapes) -> HSPMD:
    """Softmax normalizes the last dim: that dim must not be split (the
    normalizer needs every element) and the input must not be Partial
    (softmax is nonlinear in the summands)."""
    (a,) = ins
    ndim = len(shapes[0])
    for ds in a.dss:
        if ds.get(ndim - 1) > 1:
            raise DeductionError(
                "softmax dim is split; insert CommOp to gather it")
        if ds.has_partial:
            raise DeductionError(
                "softmax over a Partial tensor is nonlinear; insert "
                "CommOp to reduce first")
    if a.hdim == ndim - 1 or a.hdim == PARTIAL:
        raise DeductionError(
            "softmax dim top-split or Partial; insert CommOp")
    return a


def _deduce_norm(ins: list[HSPMD], shapes) -> HSPMD:
    """rmsnorm(x, w) / layernorm(x, w, b): the normalized (last) dim of
    x must be whole on every device; weights must be replicated along
    their feature dim (they multiply the un-split last dim)."""
    u = unify_inputs(ins)
    x = u[0]
    ndim = len(shapes[0])
    for ds in x.dss:
        if ds.get(ndim - 1) > 1:
            raise DeductionError(
                "normalized (last) dim is split; insert CommOp")
        if ds.has_partial:
            raise DeductionError(
                "norm over a Partial tensor is nonlinear; insert CommOp "
                "to reduce first")
    if x.hdim == ndim - 1 or x.hdim == PARTIAL:
        raise DeductionError(
            "normalized dim top-split or Partial; insert CommOp")
    for w in u[1:]:
        for ds in w.dss:
            if ds.get(0) > 1 or ds.has_partial:
                raise DeductionError(
                    "norm weights must be replicated; insert CommOp")
        if w.hdim != DUP:
            raise DeductionError(
                "norm weights must be replicated across subgroups")
    return x


def _deduce_gather(ins: list[HSPMD], shapes) -> HSPMD:
    """``out[b...] = x[b..., ids[b...]]`` — take along x's last axis.
    Indices are global along that axis, so it must not be split; leading
    splits must agree between x and ids; gather is linear in x, so a
    Partial x passes through, while Partial indices are meaningless."""
    xa, ia = unify_inputs(ins)
    x_ndim = len(shapes[0])
    dss = []
    for xs, is_ in zip(xa.dss, ia.dss):
        if xs.get(x_ndim - 1) > 1:
            raise DeductionError(
                "gathered (last) dim is split; insert CommOp to "
                "replicate (indices are global)")
        if is_.get(PARTIAL) > 1:
            raise DeductionError("gather indices cannot be Partial")
        entries: list[tuple[int, int]] = []
        for d in range(x_ndim - 1):
            if xs.get(d) != is_.get(d):
                raise DeductionError(
                    f"gather: x dim {d} split {xs.get(d)} does not match "
                    f"ids split {is_.get(d)}; insert CommOp")
            if is_.get(d) > 1:
                entries.append((d, is_.get(d)))
        partial = xs.get(PARTIAL)
        if partial > 1:
            entries.append((PARTIAL, partial))
        n_dev = is_.num_devices
        used = 1
        for _, n in entries:
            used *= n
        if n_dev % used != 0:
            raise DeductionError(
                f"inconsistent gather sharding: {used} does not divide "
                f"{n_dev}")
        if n_dev // used > 1:
            entries.append((DUP, n_dev // used))
        dss.append(DS(entries))
    if ia.hdim == PARTIAL or xa.hdim == x_ndim - 1:
        raise DeductionError(
            "gather indices Partial or gathered dim top-split; insert "
            "CommOp")
    if ia.hdim >= 0 and xa.hdim >= 0 and ia.hdim != xa.hdim:
        raise DeductionError(
            "gather operands top-split on different dims; insert CommOp")
    if ia.hdim >= 0:
        hdim = ia.hdim
    elif xa.hdim >= 0 or xa.hdim == PARTIAL:
        hdim = xa.hdim
    else:
        hdim = DUP
    return HSPMD(ia.dgs, dss, hdim=hdim,
                 hsplits=ia.hsplits if hdim == ia.hdim else None)


def _deduce_attention(ins: list[HSPMD], shapes) -> HSPMD:
    """attention(q, k, v): q (B,H,Sq,D); k/v (B,K,Sk,D) with H % K == 0.

    Head-dim aware: a TP split over dim 1 passes through when q and k/v
    carry the SAME shard count (H and K shards pair up groupwise under
    GQA); batch (dim 0) splits must match; sequence and head_dim splits
    have no local kernel (softmax spans the key sequence) and Partial
    operands are nonlinear — both demand a CommOp first."""
    qa, ka, va = unify_inputs(ins)
    H, K = shapes[0][1], shapes[1][1]
    dss = []
    for qs, ks, vs in zip(qa.dss, ka.dss, va.dss):
        if ks.entries != vs.entries:
            raise DeductionError(
                "attention k and v must share one sharding; insert CommOp")
        for ds, who in ((qs, "q"), (ks, "k/v")):
            if ds.has_partial:
                raise DeductionError(
                    f"attention {who} is Partial (softmax is nonlinear); "
                    f"insert CommOp to reduce first")
            if ds.get(2) > 1 or ds.get(3) > 1:
                raise DeductionError(
                    f"attention {who} split along sequence/head_dim; "
                    f"insert CommOp")
        if qs.get(0) != ks.get(0):
            raise DeductionError(
                "attention batch split mismatch between q and k/v; "
                "insert CommOp")
        n = qs.get(1)
        if ks.get(1) != n:
            raise DeductionError(
                f"attention head split mismatch (q {n} vs k/v "
                f"{ks.get(1)} shards); TP over heads must shard q and "
                f"k/v with the same group count")
        if n > 1:
            if isinstance(H, int) and H % n != 0:
                raise DeductionError(
                    f"{H} query heads not divisible by {n} shards")
            if isinstance(K, int) and K % n != 0:
                raise DeductionError(
                    f"{K} kv heads not divisible by {n} shards")
        dss.append(qs)
    hdims = {qa.hdim, ka.hdim, va.hdim}
    if PARTIAL in hdims:
        raise DeductionError("attention over top-tier Partial; insert CommOp")
    if hdims - {DUP} and (len(hdims - {DUP}) > 1
                          or next(iter(hdims - {DUP})) not in (0, 1)):
        raise DeductionError(
            "attention operands top-split beyond batch/head dims or on "
            "different dims; insert CommOp")
    if qa.hdim != ka.hdim or ka.hdim != va.hdim:
        raise DeductionError(
            "attention operands must share one top-tier split; insert "
            "CommOp")
    return HSPMD(qa.dgs, dss, hdim=qa.hdim, hsplits=qa.hsplits)


def _deduce_norm_grad_x(ins: list[HSPMD], shapes) -> HSPMD:
    """VJP of rmsnorm/layernorm wrt x: linear in ``dy`` (Partial passes
    through); the activation must match dy's splits, the weight must be
    replicated (same constraints the forward op already enforced)."""
    u = unify_inputs(ins)
    dy, x = u[0], u[1]
    for ds_dy, ds_x in zip(dy.dss, x.dss):
        if ds_x.has_partial:
            raise DeductionError(
                "norm_grad_x activation is Partial; insert CommOp")
        if ({d: n for d, n in ds_x.entries if d >= 0}
                != {d: n for d, n in ds_dy.entries if d >= 0}):
            raise DeductionError(
                "norm_grad_x operands have mismatched split dims; "
                "insert CommOp")
    for w in u[2:]:
        for ds in w.dss:
            if ds.get(0) > 1 or ds.has_partial:
                raise DeductionError(
                    "norm_grad_x weight must be replicated; insert CommOp")
    return dy


def _deduce_reduce_to_vector(ins: list[HSPMD], shapes) -> HSPMD:
    """norm_grad_w / norm_grad_b: reduce ``dy (..., d)`` over every
    leading dim to a ``(d,)`` vector.  Leading splits collapse to
    Partial summands (each device reduces its slice); a Partial dy stays
    Partial (the reduction is linear); the last dim is whole by the
    forward norm's own deduction."""
    u = unify_inputs(ins)
    dy = u[0]
    dy_ndim = len(shapes[0])
    dss = []
    for k, ds in enumerate(dy.dss):
        if ds.get(dy_ndim - 1) > 1:
            raise DeductionError(
                "norm grad feature (last) dim is split; insert CommOp")
        for other in u[1:]:
            if other.dss[k].has_partial:
                raise DeductionError(
                    "norm grad activation is Partial; insert CommOp")
        partial = ds.get(PARTIAL)
        for d, n in ds.entries:
            if d >= 0:
                partial *= n
        entries: list[tuple[int, int]] = []
        if partial > 1:
            entries.append((PARTIAL, partial))
        n_dev = ds.num_devices
        used = partial if partial > 1 else 1
        if n_dev // used > 1:
            entries.append((DUP, n_dev // used))
        dss.append(DS(entries))
    if dy.hdim == dy_ndim - 1:
        raise DeductionError(
            "norm grad feature dim top-split; insert CommOp")
    hdim = PARTIAL if (dy.hdim >= 0 or dy.hdim == PARTIAL) else DUP
    return HSPMD(dy.dgs, dss, hdim=hdim)


def _deduce_gather_grad(ins: list[HSPMD], shapes) -> HSPMD:
    """VJP of gather: a one-hot scatter along the appended last dim —
    elementwise over the leading dims, so dy's annotation carries over
    (the new dim is whole everywhere, as the forward op required)."""
    u = unify_inputs(ins)
    dy, ids = u
    for ds in ids.dss:
        if ds.has_partial:
            raise DeductionError("gather_grad indices cannot be Partial")
    return dy


DEDUCTION_RULES = {
    "gelu": lambda ins, shapes, attrs: ins[0],
    "relu": lambda ins, shapes, attrs: ins[0],
    "silu": lambda ins, shapes, attrs: ins[0],
    "rsqrt": lambda ins, shapes, attrs: ins[0],
    "scale": lambda ins, shapes, attrs: ins[0],
    "add": lambda ins, shapes, attrs: _deduce_elementwise(ins, shapes),
    "mul": lambda ins, shapes, attrs: _deduce_elementwise(ins, shapes),
    "dot": lambda ins, shapes, attrs: _deduce_dot(ins, shapes),
    "sum": lambda ins, shapes, attrs: _deduce_sum(ins, shapes, attrs["dim"]),
    "transpose": lambda ins, shapes, attrs: _deduce_transpose(
        ins, shapes, attrs["perm"]),
    "reshape": lambda ins, shapes, attrs: _deduce_reshape(
        ins, shapes, attrs["new_shape"]),
    "embedding": lambda ins, shapes, attrs: _deduce_embedding(ins, shapes),
    "softmax": lambda ins, shapes, attrs: _deduce_softmax(ins, shapes),
    "rmsnorm": lambda ins, shapes, attrs: _deduce_norm(ins, shapes),
    "layernorm": lambda ins, shapes, attrs: _deduce_norm(ins, shapes),
    "div": lambda ins, shapes, attrs: _deduce_linear_grad(ins, shapes),
    "gather": lambda ins, shapes, attrs: _deduce_gather(ins, shapes),
    "attention": lambda ins, shapes, attrs: _deduce_attention(ins, shapes),
    # backward-only kernels (reverse-mode autodiff, Graph.backward)
    "relu_grad": lambda ins, shapes, attrs: _deduce_linear_grad(ins, shapes),
    "gelu_grad": lambda ins, shapes, attrs: _deduce_linear_grad(ins, shapes),
    "silu_grad": lambda ins, shapes, attrs: _deduce_linear_grad(ins, shapes),
    "mul_grad": lambda ins, shapes, attrs: _deduce_linear_grad(ins, shapes),
    "softmax_grad": lambda ins, shapes, attrs: _deduce_linear_grad(
        ins, shapes),
    "norm_grad_x": lambda ins, shapes, attrs: _deduce_norm_grad_x(
        ins, shapes),
    "norm_grad_w": lambda ins, shapes, attrs: _deduce_reduce_to_vector(
        ins, shapes),
    "norm_grad_b": lambda ins, shapes, attrs: _deduce_reduce_to_vector(
        ins, shapes),
    "gather_grad": lambda ins, shapes, attrs: _deduce_gather_grad(ins, shapes),
    # attn_grad_k/v output k/v-shaped grads, but the split DIMS and
    # shard COUNTS equal dy's (head-group splits pair q and kv heads),
    # so the linear-grad rule's pass-through of dy's annotation is exact
    "attn_grad_q": lambda ins, shapes, attrs: _deduce_linear_grad(ins, shapes),
    "attn_grad_k": lambda ins, shapes, attrs: _deduce_linear_grad(ins, shapes),
    "attn_grad_v": lambda ins, shapes, attrs: _deduce_linear_grad(ins, shapes),
    "bcast": lambda ins, shapes, attrs: _deduce_bcast(
        ins, shapes, attrs["dim"]),
    "embed_grad": lambda ins, shapes, attrs: _deduce_embed_grad(ins, shapes),
}

# ops whose outputs carry EXPLICIT annotations (not deduced): graph
# leaves, CommOps, and the autodiff gradient seed
LEAF_KINDS = ("placeholder", "parameter", "comm", "ones")


# ---------------------------------------------------------------------------
# cotangent annotations (reverse-mode autodiff, paper §5.2 one level down)
# ---------------------------------------------------------------------------

def cotangent_annot(a: HSPMD) -> HSPMD:
    """The canonical annotation of a tensor's gradient: Split stays
    Split (the grad of a shard is the shard of the grad), while
    Duplicate and Partial SWAP — a replicated tensor consumed by many
    devices accumulates per-device grad summands (Partial), and a
    Partial tensor's summands each receive the full grad (Duplicate).
    This is the transpose of the linear map the placement realizes."""
    def swap(d: int) -> int:
        return PARTIAL if d == DUP else (DUP if d == PARTIAL else d)

    dss = [DS([(swap(d), n) for d, n in ds.entries]) for ds in a.dss]
    return HSPMD(a.dgs, dss, hdim=swap(a.hdim), hsplits=a.hsplits)


def departialize(a: HSPMD) -> HSPMD:
    """``a`` with every Partial entry turned into Duplicate (the
    annotation after an in-group all-reduce): the full-value carrier of
    the same placement geometry."""
    dss = []
    for ds in a.dss:
        m: dict[int, int] = {}
        order: list[int] = []
        for d, n in ds.entries:
            d = DUP if d == PARTIAL else d
            if d in m:
                m[d] *= n
            else:
                m[d] = n
                order.append(d)
        dss.append(DS([(d, m[d]) for d in order]))
    hdim = DUP if a.hdim == PARTIAL else a.hdim
    return HSPMD(a.dgs, dss, hdim=hdim, hsplits=a.hsplits)


def annots_equal(a: HSPMD, b: HSPMD) -> bool:
    """Exact placement equality (entry order matters: it fixes the
    device -> shard coordinate decomposition)."""
    return (a.same_dg_union(b)
            and all(x.entries == y.entries for x, y in zip(a.dss, b.dss))
            and a.hdim == b.hdim and a.hsplits == b.hsplits)


# ---------------------------------------------------------------------------
# graph builder
# ---------------------------------------------------------------------------

class Graph:
    """Single-device-view program with declarative HSPMD annotations."""

    def __init__(self):
        self.ops: list[Op] = []
        self.tensors: dict[str, Tensor] = {}
        self._n = 0
        # reverse-mode autodiff provenance (Graph.backward): forward
        # tensor name -> its gradient tensor's name, and the loss the
        # backward extension was seeded from
        self.grad_map: dict[str, str] = {}
        self.loss_name: str | None = None

    # -- leaves -------------------------------------------------------------
    def _add_tensor(self, name, shape, annots=None, producer=None) -> Tensor:
        if name in self.tensors:
            raise ValueError(f"duplicate tensor {name}")
        t = Tensor(name, tuple(shape), list(annots or []), producer)
        self.tensors[name] = t
        return t

    def placeholder(self, name: str, shape,
                    annots: Sequence[HSPMD] | None = None) -> Tensor:
        t = self._add_tensor(name, shape, annots)
        self.ops.append(Op("placeholder", [], [t]))
        t.producer = self.ops[-1]
        return t

    def parameter(self, name: str, shape,
                  annots: Sequence[HSPMD] | None = None) -> Tensor:
        t = self._add_tensor(name, shape, annots)
        self.ops.append(Op("parameter", [], [t]))
        t.producer = self.ops[-1]
        return t

    # -- CommOp (§5.1) -------------------------------------------------------
    def comm(self, x: Tensor, annots: Sequence[HSPMD] | HSPMD | None = None,
             name: str | None = None) -> Tensor:
        if isinstance(annots, HSPMD):
            annots = [annots]
        name = name or f"{x.name}'"
        out = self._add_tensor(name, x.shape, list(annots or []))
        op = Op("comm", [x], [out], {"id": sum(1 for o in self.ops
                                               if o.kind == "comm") + 1})
        self.ops.append(op)
        out.producer = op
        return out

    # -- compute ops ----------------------------------------------------------
    def _compute(self, kind: str, ins: list[Tensor], out_shape,
                 name: str | None = None, **attrs) -> Tensor:
        name = name or f"{kind}_{self._n}"
        self._n += 1
        out = self._add_tensor(name, out_shape)
        op = Op(kind, list(ins), [out], dict(attrs))
        self.ops.append(op)
        out.producer = op
        return out

    def gelu(self, x, name=None):
        return self._compute("gelu", [x], x.shape, name)

    def relu(self, x, name=None):
        return self._compute("relu", [x], x.shape, name)

    def add(self, a, b, name=None):
        return self._compute("add", [a, b], a.shape, name)

    def mul(self, a, b, name=None):
        return self._compute("mul", [a, b], a.shape, name)

    def dot(self, x, w, name=None):
        out_shape = tuple(x.shape[:-1]) + (w.shape[-1],)
        return self._compute("dot", [x, w], out_shape, name)

    def sum(self, x, dim: int, name=None):
        out_shape = tuple(s for i, s in enumerate(x.shape) if i != dim)
        return self._compute("sum", [x], out_shape, name, dim=dim)

    def bcast(self, x, dim: int, size, name=None):
        """Insert a broadcast dim of ``size`` at ``dim`` (inverse of
        ``sum``) — e.g. lifting a ``(d,)`` bias onto ``(B, S, d)``."""
        out_shape = tuple(x.shape[:dim]) + (size,) + tuple(x.shape[dim:])
        return self._compute("bcast", [x], out_shape, name, dim=dim,
                             size=size)

    def transpose(self, x, perm, name=None):
        out_shape = tuple(x.shape[p] for p in perm)
        return self._compute("transpose", [x], out_shape, name,
                             perm=tuple(perm))

    def reshape(self, x, new_shape, name=None):
        return self._compute("reshape", [x], tuple(new_shape), name,
                             new_shape=tuple(new_shape))

    def embedding(self, table, ids, name=None):
        """Row lookup ``out[b..., :] = table[ids[b...], :]`` (the token
        embedding of a language model; indices are global vocab ids)."""
        if len(table.shape) != 2:
            raise ValueError("embedding expects a 2D (vocab, dim) table")
        out_shape = tuple(ids.shape) + (table.shape[-1],)
        return self._compute("embedding", [table, ids], out_shape, name)

    def silu(self, x, name=None):
        return self._compute("silu", [x], x.shape, name)

    def rsqrt(self, x, name=None):
        return self._compute("rsqrt", [x], x.shape, name)

    def div(self, a, b, name=None):
        """Elementwise ``a / b`` (same shapes; linear in ``a``)."""
        return self._compute("div", [a, b], a.shape, name)

    def scale(self, x, factor: float, name=None):
        return self._compute("scale", [x], x.shape, name,
                             factor=float(factor))

    def softmax(self, x, name=None):
        """Softmax over the LAST dim."""
        return self._compute("softmax", [x], x.shape, name)

    def rmsnorm(self, x, w, eps: float = 1e-5, name=None):
        """RMSNorm over the last dim: ``x * rsqrt(mean(x^2) + eps) * w``."""
        return self._compute("rmsnorm", [x, w], x.shape, name,
                             norm="rms", eps=float(eps))

    def layernorm(self, x, w, b, eps: float = 1e-5, name=None):
        """LayerNorm over the last dim: ``(x - mu) * rsqrt(var + eps) * w + b``."""
        return self._compute("layernorm", [x, w, b], x.shape, name,
                             norm="layer", eps=float(eps))

    def gather(self, x, ids, name=None):
        """``out[b...] = x[b..., ids[b...]]`` — take along x's last axis
        (the label-probability pick of a cross-entropy loss)."""
        if len(ids.shape) != len(x.shape) - 1:
            raise ValueError(
                f"gather expects ids with rank {len(x.shape) - 1}, got "
                f"{len(ids.shape)}")
        return self._compute("gather", [x, ids], tuple(ids.shape), name)

    def attention(self, q, k, v, causal: bool = True, name=None):
        """Scaled-dot-product attention: ``q (B, H, Sq, D)``, ``k``/``v``
        ``(B, K, Sk, D)`` with ``H % K == 0`` (GQA).  Lowered per device
        to the Pallas flash kernel or the pure-XLA reference according
        to ``kernels.policy`` (see ``runtime.program``)."""
        for t in (q, k, v):
            if len(t.shape) != 4:
                raise ValueError("attention expects 4D (B, heads, S, D)")
        H, K = q.shape[1], k.shape[1]
        if isinstance(H, int) and isinstance(K, int) and H % K != 0:
            raise ValueError(
                f"attention query heads {H} not a multiple of kv heads {K}")
        return self._compute("attention", [q, k, v], q.shape, name,
                             causal=bool(causal))

    def transformer_block(self, cfg, **kw):
        """Append one full transformer block (pre-norm attention + MLP)
        shaped by a ``configs`` ModelConfig; see ``models.graph_block``
        for the layout and the TP×DP×PP annotation helper."""
        from ..models.graph_block import build_block
        return build_block(self, cfg, **kw)

    # -- reverse-mode autodiff ----------------------------------------------
    def _bwd(self, kind: str, ins: list[Tensor], out_shape, anchor: str,
             grad_of: str | None = None, name: str | None = None,
             **attrs) -> Tensor:
        """Append one backward op and deduce its annotations immediately
        (the forward graph is already annotated, and backward ops are
        built in dataflow order, so every input is annotated).  Every
        backward op carries ``phase="bwd"`` plus ``fwd_anchor`` — the
        forward tensor whose (virtual) pipeline stage it executes in —
        and grad-producing ops additionally carry ``grad_of``."""
        t = self._compute(kind, list(ins), out_shape, name, **attrs)
        op = t.producer
        op.attrs["phase"] = "bwd"
        op.attrs["fwd_anchor"] = anchor
        if grad_of is not None:
            op.attrs["grad_of"] = grad_of
        rule = DEDUCTION_RULES[kind]
        shapes = [i.shape for i in ins]
        n = max(len(i.annots) for i in ins)
        t.annots = [rule([i.annots[k] for i in ins], shapes, op.attrs)
                    for k in range(n)]
        return t

    def _bwd_comm(self, x: Tensor, annots, anchor: str,
                  grad_of: str | None = None,
                  name: str | None = None) -> Tensor:
        # a Partial gradient whose SPLIT structure also changes (e.g.
        # dw [(Partial,dp),(1,tp)] -> a replicated param) is not one
        # collective; all-reduce in place first, then redistribute
        hops, hop_needed = [], False
        for have, tgt in zip(x.annots, list(annots)):
            def _splits(a):
                return [{d: n for d, n in ds.entries if d >= 0}
                        for ds in a.dss]
            if (have.has_partial and not annots_equal(have, tgt)
                    and any(_splits(have)) and _splits(have) != _splits(tgt)
                    and have.same_dg_union(tgt)):
                hops.append(departialize(have))
                hop_needed = True
            else:
                hops.append(have)
        if hop_needed:
            x = self._bwd_comm(x, hops, anchor)
        out = self.comm(x, list(annots), name=name)
        op = out.producer
        op.attrs["phase"] = "bwd"
        op.attrs["fwd_anchor"] = anchor
        if grad_of is not None:
            op.attrs["grad_of"] = grad_of
        return out

    def _canonicalize_grad(self, gt: Tensor, x: Tensor, anchor: str,
                           grad_of: str) -> Tensor:
        """Reshard gradient contribution ``gt`` onto ``x``'s cotangent
        placement (:func:`cotangent_annot`) so backward deduction always
        sees the same sharding patterns the forward graph used.

        Where the cotangent keeps a Partial that communication cannot
        create (comm resolution never *introduces* summands), the
        departialized full-value carrier is used instead; a Partial
        contribution that must cross device groups is all-reduced in
        its own group first (Partial tensors cannot move across unions,
        paper §4.3)."""
        n = len(x.annots)
        wants = [cotangent_annot(a) for a in x.annots]
        targets: list[HSPMD] = []
        need = False
        for k in range(n):
            have, want = gt.annots[k], wants[k]
            if annots_equal(have, want) or \
                    annots_equal(have, departialize(want)):
                targets.append(have)
                continue
            targets.append(departialize(want) if want.has_partial
                           else want)
            need = True
        if not need:
            return gt
        hops: list[HSPMD] = []
        hop_needed = False
        for k in range(n):
            have, tgt = gt.annots[k], targets[k]
            if have.has_partial and not annots_equal(have, tgt) and (
                    have.hsize != tgt.hsize
                    or not have.same_dg_union(tgt)):
                hops.append(departialize(have))
                hop_needed = True
            else:
                hops.append(have)
        if hop_needed:
            gt = self._bwd_comm(gt, hops, anchor)
        return self._bwd_comm(gt, targets, anchor, grad_of=grad_of)

    def backward(self, loss: "Tensor | str | None" = None,
                 wrt: "Sequence[Tensor | str] | None" = None
                 ) -> dict[str, str]:
        """Extend this *deduced* forward graph in place with its
        reverse-mode backward pass (the joint fwd+bwd training graph).

        A per-op-kind VJP registry (:data:`VJP_RULES`) emits each
        operator's backward as ordinary graph ops, so the existing
        deduction rules propagate DS annotations through the backward
        half unchanged; gradient contributions are resharded onto each
        tensor's cotangent placement (Split stays Split, Duplicate and
        Partial swap), accumulated across consumers, and finally every
        parameter gradient is communicated onto the parameter's OWN
        annotation (Partial -> Duplicate becomes an all-reduce, Partial
        -> Split a reduce-scatter over the DP dim — resolved by §4 comm
        resolution like any other CommOp).

        ``loss`` defaults to the graph's single scalar sink; ``wrt``
        to all parameters.  Returns (and stores as ``self.grad_map``)
        the ``forward tensor name -> gradient tensor name`` provenance.
        """
        if self.grad_map:
            raise GradError("graph already extended with a backward pass")
        if loss is None:
            scalars = [t for t in self.sinks() if tuple(t.shape) == ()]
            if len(scalars) != 1:
                raise GradError(
                    f"graph has {len(scalars)} scalar sink(s); pass "
                    f"loss= to pick the tensor to differentiate")
            loss_t = scalars[0]
        else:
            name = loss.name if isinstance(loss, Tensor) else loss
            if name not in self.tensors:
                raise GradError(f"unknown loss tensor {name!r}")
            loss_t = self.tensors[name]
        if tuple(loss_t.shape) != ():
            raise GradError(
                f"loss {loss_t.name!r} must be scalar; got shape "
                f"{loss_t.shape} (reduce it with sum)")
        if not loss_t.annots:
            raise GradError(
                "run deduce() before backward(): autodiff propagates "
                "the deduced annotations through the backward ops")
        params = [p if isinstance(p, Tensor) else self.tensors[p]
                  for p in (wrt if wrt is not None else self.parameters())]

        fwd_ops = list(self.ops)
        contributions: dict[str, list[Tensor]] = {}
        grad_map: dict[str, str] = {}

        # seed: dL/dL == 1 on the loss's cotangent placement (a Partial
        # loss — per-device summands — receives a Duplicate seed).  The
        # full-value carrier (departialize) is essential: a Duplicate
        # entry in the loss swaps to Partial in the cotangent, and a
        # "ones" op materializing 1.0 per summand would represent a seed
        # of n, silently scaling every gradient
        seed = self._add_tensor(
            f"d/{loss_t.name}", (),
            [departialize(cotangent_annot(a)) for a in loss_t.annots])
        seed_op = Op("ones", [], [seed],
                     {"phase": "bwd", "grad_of": loss_t.name,
                      "fwd_anchor": loss_t.name})
        self.ops.append(seed_op)
        seed.producer = seed_op
        contributions[loss_t.name] = [seed]

        def combine(t: Tensor) -> "Tensor | None":
            contribs = contributions.get(t.name)
            if not contribs:
                return None
            n = len(t.annots)
            if len(contribs) > 1 and any(
                    not annots_equal(c.annots[k], contribs[0].annots[k])
                    for c in contribs[1:] for k in range(n)):
                # mixed Partial/Duplicate carriers: converge on the
                # full-value carrier of the cotangent placement
                wants = [cotangent_annot(a) for a in t.annots]
                targets = [
                    contribs[0].annots[k]
                    if all(annots_equal(c.annots[k], contribs[0].annots[k])
                           for c in contribs[1:])
                    else departialize(wants[k])
                    for k in range(n)]
                contribs = [
                    c if all(annots_equal(c.annots[k], targets[k])
                             for k in range(n))
                    else self._bwd_comm(c, targets, anchor=t.name)
                    for c in contribs]
            acc = contribs[0]
            for c in contribs[1:]:
                acc = self._bwd("add", [acc, c], tuple(t.shape),
                                anchor=t.name, grad_of=t.name)
            grad_map[t.name] = acc.name
            return acc

        for op in reversed(fwd_ops):
            if op.kind in ("placeholder", "parameter"):
                continue
            out = op.outputs[0]
            dy = combine(out)
            if dy is None:
                continue  # not on the loss path
            rule = VJP_RULES.get(op.kind)
            if rule is None:
                raise GradError(f"no VJP rule for op kind {op.kind!r}")
            for x, gt in zip(op.inputs, rule(self, op, dy)):
                if gt is None:
                    continue
                gt = self._canonicalize_grad(gt, x, anchor=out.name,
                                             grad_of=x.name)
                contributions.setdefault(x.name, []).append(gt)

        # parameter gradients: reduce onto the parameter's own placement
        # so the optimizer applies elementwise sharded updates — a
        # Duplicate(DP) param's Partial grad all-reduces, a Split param's
        # Partial grad reduce-scatters (comm_resolve picks the operator)
        for p in params:
            gt = combine(p)
            if gt is None:
                raise GradError(
                    f"parameter {p.name!r} is not on the loss path")
            if any(not annots_equal(gt.annots[k], p.annots[k])
                   for k in range(len(p.annots))):
                gt = self._bwd_comm(gt, list(p.annots), anchor=p.name,
                                    grad_of=p.name, name=f"d/{p.name}")
            grad_map[p.name] = gt.name
        for op in fwd_ops:         # input grads are useful fetches too
            if op.kind == "placeholder" and \
                    op.outputs[0].name not in grad_map:
                combine(op.outputs[0])
        self.grad_map = grad_map
        self.loss_name = loss_t.name
        return grad_map

    # -- deduction (§5.2) -----------------------------------------------------
    def deduce(self) -> "Graph":
        """Fill in annotations for every tensor, per strategy index."""
        n_strat = max((len(t.annots) for t in self.tensors.values()
                       if t.annots), default=1)
        for op in self.ops:
            if op.kind in LEAF_KINDS:
                for t in op.outputs:
                    if not t.annots:
                        raise DeductionError(f"leaf/comm {t.name} needs annots")
                    if len(t.annots) not in (1, n_strat):
                        raise DeductionError(
                            f"{t.name}: {len(t.annots)} annots, expected "
                            f"1 or {n_strat}")
                    if len(t.annots) == 1 and n_strat > 1:
                        t.annots = t.annots * n_strat
                continue
            rule = DEDUCTION_RULES.get(op.kind)
            if rule is None:
                raise DeductionError(f"no deduction rule for op {op.kind}")
            shapes = [t.shape for t in op.inputs]
            for t in op.outputs:
                t.annots = []
            for k in range(n_strat):
                ins = [t.annots[k] for t in op.inputs]
                out = rule(ins, shapes, op.attrs)
                for t in op.outputs:
                    t.annots.append(out)
        return self

    @property
    def comm_ops(self) -> list[Op]:
        return [o for o in self.ops if o.kind == "comm"]

    def parameters(self) -> list[Tensor]:
        return [o.outputs[0] for o in self.ops if o.kind == "parameter"]

    def placeholders(self) -> list[Tensor]:
        return [o.outputs[0] for o in self.ops if o.kind == "placeholder"]

    def annotation_points(self) -> list[Tensor]:
        """Tensors that carry *explicit* (non-deduced) annotations: leaves
        and CommOp outputs — exactly what a parallel-strategy bundle must
        cover (paper §6.1's multiple-annotation binding sites)."""
        return [o.outputs[0] for o in self.ops
                if o.kind in ("placeholder", "parameter", "comm")]

    def sinks(self) -> list[Tensor]:
        """Tensors no op consumes — the program's default outputs."""
        consumed = {id(t) for o in self.ops for t in o.inputs}
        return [o.outputs[0] for o in self.ops
                if o.outputs and id(o.outputs[0]) not in consumed]

    def deduction_report(self) -> "DeductionReport":
        """Run deduction and return a stable summary the API layer
        composes (tensor/op counts, per-strategy device universes)."""
        self.deduce()
        n_strat = max((len(t.annots) for t in self.tensors.values()
                       if t.annots), default=1)
        devices = []
        for k in range(n_strat):
            devs: set[int] = set()
            for t in self.tensors.values():
                if t.annots:
                    devs |= set(t.annots[k].devices)
            devices.append(tuple(sorted(devs)))
        return DeductionReport(
            n_strategies=n_strat,
            n_ops=len(self.ops),
            n_comm_ops=len(self.comm_ops),
            n_tensors=len(self.tensors),
            devices=tuple(devices),
        )


# ---------------------------------------------------------------------------
# per-op-kind VJP registry (reverse-mode autodiff)
# ---------------------------------------------------------------------------
#
# Each rule takes ``(g, op, dy)`` — the graph, the forward op, and the
# (already combined) gradient of the op's output — and returns one
# gradient contribution per op input (``None`` for non-differentiable
# inputs such as integer indices).  Rules emit ordinary graph ops via
# ``g._bwd`` so DS/HDim deduction runs through them unchanged; the
# caller (``Graph.backward``) reshards every contribution onto the
# input's cotangent placement.

def _vjp_elementwise_act(kind_grad: str):
    def vjp(g: "Graph", op: Op, dy: Tensor) -> list:
        (x,) = op.inputs
        anchor = op.outputs[0].name
        return [g._bwd(kind_grad, [dy, x], tuple(x.shape), anchor,
                       grad_of=x.name)]
    return vjp


def _vjp_scale(g: "Graph", op: Op, dy: Tensor) -> list:
    (x,) = op.inputs
    return [g._bwd("scale", [dy], tuple(x.shape), op.outputs[0].name,
                   grad_of=x.name, factor=op.attrs.get("factor", 1.0))]


def _vjp_add(g: "Graph", op: Op, dy: Tensor) -> list:
    return [dy, dy]


def _vjp_mul(g: "Graph", op: Op, dy: Tensor) -> list:
    a, b = op.inputs
    anchor = op.outputs[0].name
    da = g._bwd("mul_grad", [dy, b], tuple(a.shape), anchor, grad_of=a.name)
    db = g._bwd("mul_grad", [dy, a], tuple(b.shape), anchor, grad_of=b.name)
    return [da, db]


def _vjp_dot(g: "Graph", op: Op, dy: Tensor) -> list:
    x, w = op.inputs
    anchor = op.outputs[0].name
    wt = g._bwd("transpose", [w], (w.shape[1], w.shape[0]), anchor,
                perm=(1, 0))
    dx = g._bwd("dot", [dy, wt], tuple(x.shape), anchor, grad_of=x.name)
    if len(x.shape) == 2:
        x2, dy2 = x, dy
    else:
        # symbolic leading dims flatten as expression trees (prod_dims)
        # and bind alongside the rest of the shape at compile time
        from .symbolic import prod_dims
        m = prod_dims(x.shape[:-1])
        x2 = g._bwd("reshape", [x], (m, x.shape[-1]), anchor,
                    new_shape=(m, x.shape[-1]))
        dy2 = g._bwd("reshape", [dy], (m, w.shape[1]), anchor,
                     new_shape=(m, w.shape[1]))
    xt = g._bwd("transpose", [x2], (x2.shape[1], x2.shape[0]), anchor,
                perm=(1, 0))
    dw = g._bwd("dot", [xt, dy2], tuple(w.shape), anchor, grad_of=w.name)
    return [dx, dw]


def _vjp_sum(g: "Graph", op: Op, dy: Tensor) -> list:
    (x,) = op.inputs
    dim = op.attrs["dim"]
    return [g._bwd("bcast", [dy], tuple(x.shape), op.outputs[0].name,
                   grad_of=x.name, dim=dim, size=x.shape[dim])]


def _vjp_bcast(g: "Graph", op: Op, dy: Tensor) -> list:
    (x,) = op.inputs
    return [g._bwd("sum", [dy], tuple(x.shape), op.outputs[0].name,
                   grad_of=x.name, dim=op.attrs["dim"])]


def _vjp_transpose(g: "Graph", op: Op, dy: Tensor) -> list:
    (x,) = op.inputs
    perm = op.attrs["perm"]
    inv = [0] * len(perm)
    for new, old in enumerate(perm):
        inv[old] = new
    return [g._bwd("transpose", [dy], tuple(x.shape), op.outputs[0].name,
                   grad_of=x.name, perm=tuple(inv))]


def _vjp_reshape(g: "Graph", op: Op, dy: Tensor) -> list:
    (x,) = op.inputs
    return [g._bwd("reshape", [dy], tuple(x.shape), op.outputs[0].name,
                   grad_of=x.name, new_shape=tuple(x.shape))]


def _vjp_embedding(g: "Graph", op: Op, dy: Tensor) -> list:
    table, ids = op.inputs
    dt = g._bwd("embed_grad", [dy, ids], tuple(table.shape),
                op.outputs[0].name, grad_of=table.name,
                vocab=table.shape[0])
    return [dt, None]  # integer indices carry no gradient


def _vjp_comm(g: "Graph", op: Op, dy: Tensor) -> list:
    # the redistribution map is linear; its transpose is realized by the
    # caller's cotangent resharding of this contribution (an AR/RS/AG/BSR
    # mirroring the forward CommOp), so the rule itself is the identity
    return [dy]


def _vjp_softmax(g: "Graph", op: Op, dy: Tensor) -> list:
    (x,) = op.inputs
    y = op.outputs[0]
    return [g._bwd("softmax_grad", [dy, y], tuple(x.shape), y.name,
                   grad_of=x.name)]


def _vjp_rsqrt(g: "Graph", op: Op, dy: Tensor) -> list:
    # d(x^-1/2)/dx = -x^-3/2 / 2 = -y^3 / 2, from the saved output
    (x,) = op.inputs
    y = op.outputs[0]
    t = dy
    for _ in range(3):
        t = g._bwd("mul_grad", [t, y], tuple(x.shape), y.name)
    return [g._bwd("scale", [t], tuple(x.shape), y.name, grad_of=x.name,
                   factor=-0.5)]


def _vjp_div(g: "Graph", op: Op, dy: Tensor) -> list:
    a, b = op.inputs
    y = op.outputs[0]
    da = g._bwd("div", [dy, b], tuple(a.shape), y.name, grad_of=a.name)
    # db = -dy * a / b^2 = -(dy * y) / b, reusing the saved quotient
    t = g._bwd("mul_grad", [dy, y], tuple(b.shape), y.name)
    t = g._bwd("div", [t, b], tuple(b.shape), y.name)
    db = g._bwd("scale", [t], tuple(b.shape), y.name, grad_of=b.name,
                factor=-1.0)
    return [da, db]


def _vjp_norm(g: "Graph", op: Op, dy: Tensor) -> list:
    x, w = op.inputs[0], op.inputs[1]
    anchor = op.outputs[0].name
    attrs = {"norm": op.attrs.get("norm", "rms"),
             "eps": op.attrs.get("eps", 1e-5)}
    dx = g._bwd("norm_grad_x", [dy, x, w], tuple(x.shape), anchor,
                grad_of=x.name, **attrs)
    dw = g._bwd("norm_grad_w", [dy, x], tuple(w.shape), anchor,
                grad_of=w.name, **attrs)
    grads = [dx, dw]
    if len(op.inputs) == 3:       # layernorm bias
        b = op.inputs[2]
        grads.append(g._bwd("norm_grad_b", [dy], tuple(b.shape), anchor,
                            grad_of=b.name))
    return grads


def _vjp_gather(g: "Graph", op: Op, dy: Tensor) -> list:
    x, ids = op.inputs
    dx = g._bwd("gather_grad", [dy, ids], tuple(x.shape),
                op.outputs[0].name, grad_of=x.name)
    return [dx, None]  # integer indices carry no gradient


def _vjp_attention(g: "Graph", op: Op, dy: Tensor) -> list:
    q, k, v = op.inputs
    anchor = op.outputs[0].name
    causal = op.attrs.get("causal", True)
    return [g._bwd(kind, [dy, q, k, v], tuple(t.shape), anchor,
                   grad_of=t.name, causal=causal)
            for kind, t in (("attn_grad_q", q), ("attn_grad_k", k),
                            ("attn_grad_v", v))]


VJP_RULES = {
    "gelu": _vjp_elementwise_act("gelu_grad"),
    "relu": _vjp_elementwise_act("relu_grad"),
    "silu": _vjp_elementwise_act("silu_grad"),
    "scale": _vjp_scale,
    "add": _vjp_add,
    "mul": _vjp_mul,
    "dot": _vjp_dot,
    "sum": _vjp_sum,
    "bcast": _vjp_bcast,
    "transpose": _vjp_transpose,
    "reshape": _vjp_reshape,
    "embedding": _vjp_embedding,
    "comm": _vjp_comm,
    "softmax": _vjp_softmax,
    "rsqrt": _vjp_rsqrt,
    "div": _vjp_div,
    "rmsnorm": _vjp_norm,
    "layernorm": _vjp_norm,
    "gather": _vjp_gather,
    "attention": _vjp_attention,
}


@dataclass(frozen=True)
class DeductionReport:
    """Stable result of annotation deduction over a graph."""

    n_strategies: int
    n_ops: int
    n_comm_ops: int
    n_tensors: int
    devices: tuple[tuple[int, ...], ...]  # per-strategy device universe
