"""HSPMD sharding annotations (paper §3).

Two-tier annotation structure:

* Bottom tier — classical SPMD ``DS`` (*Distributed States*): an ordered
  mapping ``dim -> #shards`` over a ``DG`` (*Device Group*, an ordered list
  of device ids).  Dim semantics follow the paper:

    - ``d >= 0``  — *Split*: tensor split uniformly along physical dim d,
    - ``d == DUP (-1)`` — *Duplicate*: full replica,
    - ``d == PARTIAL (-2)`` — *Partial*: device holds a summand.

* Top tier — ``HSPMD``: a union of ``HSize`` (DG, DS) pairs ("sharding
  subgroups"), related along a heterogeneous dimension ``HDim``:

    - ``hdim >= 0`` — tensor split along that dim *across* subgroups
      (optionally non-uniformly via ``hsplits``),
    - ``hdim == DUP`` — replicated across subgroups,
    - ``hdim == PARTIAL`` — subgroups hold summands (appears only as a
      deduction intermediate, e.g. contraction split across subgroups).

Device -> shard mapping: a device's position ``p`` in its DG is decomposed
row-major over the DS entries *in order* (first entry is the slowest-varying
coordinate), mirroring the paper's ordered-dict semantics.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

DUP = -1
PARTIAL = -2


def _norm_entries(entries: Iterable[tuple[int, int]]) -> tuple[tuple[int, int], ...]:
    out = []
    seen = set()
    for d, n in entries:
        d = int(d)
        n = int(n)
        if d < PARTIAL:
            raise ValueError(f"invalid dim {d}")
        if n <= 0:
            raise ValueError(f"invalid shard count {n} for dim {d}")
        if n == 1:
            continue  # trivial; canonical form omits it
        if d in seen:
            # duplicate DUP/PARTIAL entries are just as inconsistent as
            # duplicate splits: get() would see only the first while
            # num_devices multiplies both, silently corrupting the
            # device -> shard decomposition
            name = {DUP: "Duplicate", PARTIAL: "Partial"}.get(d, f"dim {d}")
            raise ValueError(f"{name} annotated twice in DS entries")
        seen.add(d)
        out.append((d, n))
    return tuple(out)


@dataclass(frozen=True)
class DS:
    """Bottom-tier distributed states: ordered (dim, nshards) entries."""

    entries: tuple[tuple[int, int], ...] = ()

    def __init__(self, entries: Iterable[tuple[int, int]] | Mapping[int, int] = ()):
        if isinstance(entries, Mapping):
            entries = entries.items()
        object.__setattr__(self, "entries", _norm_entries(entries))

    # -- basic queries ----------------------------------------------------
    @property
    def num_devices(self) -> int:
        return math.prod(n for _, n in self.entries) if self.entries else 1

    def get(self, dim: int) -> int:
        for d, n in self.entries:
            if d == dim:
                return n
        return 1

    @property
    def split_dims(self) -> tuple[int, ...]:
        return tuple(d for d, _ in self.entries if d >= 0)

    @property
    def has_partial(self) -> bool:
        return self.get(PARTIAL) > 1

    def same_sharding(self, other: "DS") -> bool:
        """True if the dim->n maps agree (ignoring entry order)."""
        return dict(self.entries) == dict(other.entries)

    # -- device coordinate decomposition ----------------------------------
    def coords(self, pos: int) -> dict[int, int]:
        """Decompose device position (row-major over entries) into a
        per-dim shard coordinate map."""
        if not (0 <= pos < self.num_devices):
            raise ValueError(f"device position {pos} out of range")
        out: dict[int, int] = {}
        rem = pos
        for d, n in reversed(self.entries):
            out[d] = rem % n
            rem //= n
        return out

    def positions_varying(self, dim: int) -> list[list[int]]:
        """Group device positions into lists that differ only in ``dim``'s
        coordinate (i.e. the communication groups for a collective over
        ``dim``), each ordered by that coordinate."""
        groups: dict[tuple, list[int]] = {}
        for p in range(self.num_devices):
            c = self.coords(p)
            key = tuple(sorted((d, i) for d, i in c.items() if d != dim))
            groups.setdefault(key, []).append(p)
        res = []
        for key, ps in sorted(groups.items()):
            ps.sort(key=lambda p: self.coords(p).get(dim, 0))
            res.append(ps)
        return res

    # -- shard geometry ----------------------------------------------------
    def local_box(self, pos: int, shape: Sequence[int]) -> tuple[tuple[int, int], ...]:
        """Global-coordinate box (start, stop) per tensor dim held by the
        device at ``pos`` (Partial/Dup do not affect geometry)."""
        c = self.coords(pos)
        box = []
        for dim, size in enumerate(shape):
            n = self.get(dim)
            if size % n != 0:
                raise ValueError(f"dim {dim} of size {size} not divisible by {n}")
            step = size // n
            i = c.get(dim, 0)
            box.append((i * step, (i + 1) * step))
        return tuple(box)

    def local_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return tuple(s // self.get(d) for d, s in enumerate(shape))

    def replace(self, **dim_to_n: int) -> "DS":
        """Functional update by dim (kw form: use d0=, dm1=, dm2= helpers)."""
        raise NotImplementedError("use DS(dict) construction instead")

    def with_dim(self, dim: int, n: int) -> "DS":
        m = dict(self.entries)
        if n == 1:
            m.pop(dim, None)
        else:
            m[dim] = n
        # preserve original entry order where possible; new dims appended
        order = [d for d, _ in self.entries if d in m]
        order += [d for d in m if d not in order]
        return DS([(d, m[d]) for d in order])

    def __repr__(self) -> str:
        if not self.entries:
            return "DS{}"
        parts = []
        for d, n in self.entries:
            name = {DUP: "dup", PARTIAL: "partial"}.get(d, f"s{d}")
            parts.append(f"{name}:{n}")
        return "DS{" + ",".join(parts) + "}"


@dataclass(frozen=True)
class DG:
    """Ordered device group."""

    devices: tuple[int, ...]

    def __init__(self, devices: Iterable[int]):
        devs = tuple(int(d) for d in devices)
        if len(set(devs)) != len(devs):
            raise ValueError("duplicate devices in DG")
        object.__setattr__(self, "devices", devs)

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, i: int) -> int:
        return self.devices[i]

    def index(self, dev: int) -> int:
        return self.devices.index(dev)

    def __repr__(self) -> str:
        return f"DG{list(self.devices)}"


@dataclass(frozen=True)
class HSPMD:
    """Top-tier annotation: DG Union + DS Union + (HDim, optional HSplits)."""

    dgs: tuple[DG, ...]
    dss: tuple[DS, ...]
    hdim: int = DUP
    hsplits: tuple[int, ...] | None = None  # non-uniform split numerators

    def __init__(
        self,
        dgs: Sequence[DG | Sequence[int]],
        dss: Sequence[DS | Mapping[int, int]],
        hdim: int = DUP,
        hsplits: Sequence[int] | None = None,
    ):
        dgs = tuple(dg if isinstance(dg, DG) else DG(dg) for dg in dgs)
        dss = tuple(ds if isinstance(ds, DS) else DS(ds) for ds in dss)
        if len(dgs) != len(dss):
            raise ValueError("DG Union and DS Union must have equal HSize")
        if not dgs:
            raise ValueError("empty union")
        seen: set[int] = set()
        for dg, ds in zip(dgs, dss):
            if len(dg) != ds.num_devices:
                raise ValueError(
                    f"DG size {len(dg)} != DS device count {ds.num_devices}")
            if seen & set(dg.devices):
                raise ValueError("sharding subgroups must be disjoint")
            seen |= set(dg.devices)
        hdim = int(hdim)
        if hdim < PARTIAL:
            raise ValueError(f"invalid hdim {hdim}")
        if len(dgs) == 1 and hsplits is None:
            hdim = DUP  # top tier is trivial for a single subgroup
        if hsplits is not None:
            hsplits = tuple(int(x) for x in hsplits)
            if len(hsplits) != len(dgs):
                raise ValueError("hsplits length must equal HSize")
            if hdim < 0:
                raise ValueError("hsplits requires a split hdim >= 0")
        object.__setattr__(self, "dgs", dgs)
        object.__setattr__(self, "dss", dss)
        object.__setattr__(self, "hdim", hdim)
        object.__setattr__(self, "hsplits", hsplits)

    # -- queries -----------------------------------------------------------
    @property
    def hsize(self) -> int:
        return len(self.dgs)

    @property
    def devices(self) -> tuple[int, ...]:
        return tuple(d for dg in self.dgs for d in dg)

    @property
    def has_partial(self) -> bool:
        return self.hdim == PARTIAL or any(ds.has_partial for ds in self.dss)

    def subgroup_of(self, dev: int) -> int:
        for i, dg in enumerate(self.dgs):
            if dev in dg.devices:
                return i
        raise KeyError(dev)

    def same_dg_union(self, other: "HSPMD") -> bool:
        return self.hsize == other.hsize and all(
            a.devices == b.devices for a, b in zip(self.dgs, other.dgs))

    def same_ds_union(self, other: "HSPMD") -> bool:
        return self.hsize == other.hsize and all(
            a.same_sharding(b) for a, b in zip(self.dss, other.dss))

    # -- geometry ----------------------------------------------------------
    def _hdim_bounds(self, size: int) -> list[tuple[int, int]]:
        """Start/stop of every subgroup's slab along hdim."""
        if self.hdim < 0:
            return [(0, size)] * self.hsize
        if self.hsplits is not None:
            tot = sum(self.hsplits)
            if size % tot != 0:
                raise ValueError(f"hdim size {size} not divisible by hsplits sum {tot}")
            unit = size // tot
            bounds, acc = [], 0
            for w in self.hsplits:
                bounds.append((acc * unit, (acc + w) * unit))
                acc += w
            return bounds
        if size % self.hsize != 0:
            raise ValueError(f"hdim size {size} not divisible by HSize {self.hsize}")
        step = size // self.hsize
        return [(i * step, (i + 1) * step) for i in range(self.hsize)]

    def subgroup_shape(self, g: int, shape: Sequence[int]) -> tuple[int, ...]:
        """The slab-of-global shape that subgroup ``g`` shards internally."""
        shape = list(shape)
        if self.hdim >= 0:
            lo, hi = self._hdim_bounds(shape[self.hdim])[g]
            shape[self.hdim] = hi - lo
        return tuple(shape)

    def device_box(self, dev: int, shape: Sequence[int]) -> tuple[tuple[int, int], ...]:
        """Global box held by ``dev`` (Partial treated geometrically as the
        full covered box; summand semantics live in the simulator)."""
        g = self.subgroup_of(dev)
        sub_shape = self.subgroup_shape(g, shape)
        pos = self.dgs[g].index(dev)
        box = list(self.dss[g].local_box(pos, sub_shape))
        if self.hdim >= 0:
            lo, _ = self._hdim_bounds(shape[self.hdim])[g]
            b = box[self.hdim]
            box[self.hdim] = (b[0] + lo, b[1] + lo)
        return tuple(box)

    def device_shape(self, dev: int, shape: Sequence[int]) -> tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.device_box(dev, shape))

    def partial_degree(self, dev: int) -> int:
        """Number of summands that must be reduced to realize the value of
        this device's box (bottom partial x top partial)."""
        g = self.subgroup_of(dev)
        deg = self.dss[g].get(PARTIAL)
        if self.hdim == PARTIAL:
            deg *= self.hsize
        return deg

    def __repr__(self) -> str:
        hname = {DUP: "dup", PARTIAL: "partial"}.get(self.hdim, f"s{self.hdim}")
        body = ", ".join(f"{dg}:{ds}" for dg, ds in zip(self.dgs, self.dss))
        extra = f", hsplits={list(self.hsplits)}" if self.hsplits else ""
        return f"HSPMD[hdim={hname}{extra} | {body}]"


# ---------------------------------------------------------------------------
# convenience constructors
# ---------------------------------------------------------------------------

def spmd(devices: Sequence[int], ds: DS | Mapping[int, int]) -> HSPMD:
    """Classical single-group SPMD annotation (HSize == 1)."""
    return HSPMD([DG(devices)], [ds if isinstance(ds, DS) else DS(ds)])


def replicated(devices: Sequence[int]) -> HSPMD:
    return spmd(devices, DS({DUP: len(devices)}))
