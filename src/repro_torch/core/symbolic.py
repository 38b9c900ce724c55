"""Symbolic shape extension (paper §5.5).

Annotations define the sharding *pattern*; concrete shard shapes resolve at
runtime.  Tensor metadata may carry symbolic dims (e.g. ``B`` for batch,
``S`` for sequence); constraint-preserving arithmetic (``B // 2`` when
splitting the batch dim) is tracked as expression trees and bound to
integers when inputs arrive.  Binding validates divisibility so invalid
symbol usage is rejected before it can produce shape-mismatched
communication (paper footnote 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Union

Dim = Union[int, "SymExpr"]


class SymExpr:
    """Base for symbolic dimension expressions."""

    def __add__(self, o): return _binop("+", self, o)
    def __radd__(self, o): return _binop("+", o, self)
    def __mul__(self, o): return _binop("*", self, o)
    def __rmul__(self, o): return _binop("*", o, self)
    def __floordiv__(self, o): return _binop("//", self, o)
    def __sub__(self, o): return _binop("-", self, o)

    def bind(self, env: Mapping[str, int]) -> int:
        raise NotImplementedError

    def free_symbols(self) -> set[str]:
        raise NotImplementedError


@dataclass(frozen=True)
class Sym(SymExpr):
    name: str

    def bind(self, env):
        if self.name not in env:
            raise KeyError(f"unbound symbol {self.name!r}")
        return int(env[self.name])

    def free_symbols(self):
        return {self.name}

    def __repr__(self):
        return self.name


@dataclass(frozen=True)
class BinOp(SymExpr):
    op: str
    lhs: Dim
    rhs: Dim

    def bind(self, env):
        l = self.lhs.bind(env) if isinstance(self.lhs, SymExpr) else self.lhs
        r = self.rhs.bind(env) if isinstance(self.rhs, SymExpr) else self.rhs
        if self.op == "+":
            return l + r
        if self.op == "-":
            return l - r
        if self.op == "*":
            return l * r
        if self.op == "//":
            if r == 0 or l % r != 0:
                raise ValueError(
                    f"symbolic dim {self!r} binds to non-divisible {l}//{r} "
                    f"— invalid symbol usage (paper §5.5 verification)")
            return l // r
        raise ValueError(self.op)

    def free_symbols(self):
        out = set()
        for x in (self.lhs, self.rhs):
            if isinstance(x, SymExpr):
                out |= x.free_symbols()
        return out

    def __repr__(self):
        return f"({self.lhs}{self.op}{self.rhs})"


def _binop(op: str, l, r) -> BinOp:
    return BinOp(op, l, r)


def prod_dims(dims) -> Dim:
    """Product of a run of dims, staying an ``int`` when every factor is
    concrete and an expression tree otherwise (the flattened leading dim
    of a >2D dot VJP over symbolic batch/seq axes)."""
    out: Dim = 1
    for d in dims:
        if isinstance(out, int) and isinstance(d, int):
            out *= d
        elif isinstance(out, int) and out == 1:
            out = d
        else:
            out = out * d
    return out


def _prod_key(d: Dim):
    """``(coefficient, sorted symbol names)`` canonical form of a pure
    product expression; ``None`` for anything else (sums, floordivs)."""
    if isinstance(d, int):
        return (d, ())
    if isinstance(d, Sym):
        return (1, (d.name,))
    if isinstance(d, BinOp) and d.op == "*":
        l, r = _prod_key(d.lhs), _prod_key(d.rhs)
        if l is None or r is None:
            return None
        return (l[0] * r[0], tuple(sorted(l[1] + r[1])))
    return None


def dims_equal(a: Dim, b: Dim) -> bool:
    """Dim equality that recognizes product expressions up to factor
    order (``B*S == S*B``); concrete ints compare numerically, other
    expressions structurally."""
    if isinstance(a, int) and isinstance(b, int):
        return a == b
    ka, kb = _prod_key(a), _prod_key(b)
    if ka is not None and kb is not None:
        return ka == kb
    return a == b


def dim_multiple_of(d: Dim, n: int):
    """``True``/``False`` when divisibility by ``n`` is provable from the
    dim alone; ``None`` when a symbolic dim defers the check to bind
    time (``annotations.local_box`` re-validates on concrete shapes)."""
    if isinstance(d, int):
        return d % n == 0
    k = _prod_key(d)
    if k is not None and k[0] % n == 0:
        return True
    return None


def bind_shape(shape: tuple[Dim, ...], env: Mapping[str, int]) -> tuple[int, ...]:
    out = []
    for d in shape:
        out.append(d.bind(env) if isinstance(d, SymExpr) else int(d))
        if out[-1] <= 0:
            raise ValueError(f"dim {d!r} bound to non-positive {out[-1]}")
    return tuple(out)


def is_concrete(shape: tuple[Dim, ...]) -> bool:
    return all(not isinstance(d, SymExpr) for d in shape)


def free_symbols(shape: tuple[Dim, ...]) -> set[str]:
    out: set[str] = set()
    for d in shape:
        if isinstance(d, SymExpr):
            out |= d.free_symbols()
    return out
