"""Named, validated bundles of HSPMD annotations (the API's `Strategy`).

A :class:`Strategy` is everything one parallelization choice needs: a
name, one HSPMD annotation per *annotation point* of the single-device
graph (leaves and CommOp outputs — the paper §6.1 binding sites), and
optionally the cluster topology the cost model should price it on.
``Program`` installs N strategies onto one graph and deduction runs per
strategy index — the paper's "one user graph, one annotated graph per
parallel strategy".
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

from repro_torch.core.annotations import DS, HSPMD, spmd
from repro_torch.core.graph import Graph
from repro_torch.core.topology import Topology


class StrategyError(ValueError):
    """Invalid strategy bundle (bad name, missing/non-HSPMD annotations)."""


@dataclass(frozen=True)
class Strategy:
    """A named bundle: tensor name -> HSPMD annotation (+ topology)."""

    name: str
    annots: Mapping[str, HSPMD]
    topology: Topology | None = field(default=None, compare=False)

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise StrategyError("strategy name must be a non-empty string")
        if not self.annots:
            raise StrategyError(
                f"strategy {self.name!r}: empty annotation bundle")
        for tname, annot in self.annots.items():
            if not isinstance(annot, HSPMD):
                raise StrategyError(
                    f"strategy {self.name!r}: annotation for {tname!r} is "
                    f"{type(annot).__name__}, expected HSPMD")
        if self.topology is not None and not isinstance(self.topology,
                                                        Topology):
            raise StrategyError(
                f"strategy {self.name!r}: topology must be a Topology")
        object.__setattr__(self, "annots", dict(self.annots))

    @property
    def devices(self) -> tuple[int, ...]:
        devs: set[int] = set()
        for annot in self.annots.values():
            devs |= set(annot.devices)
        return tuple(sorted(devs))

    def validate_against(self, graph: Graph) -> None:
        """Check this bundle covers exactly the graph's annotation points
        (leaves + CommOp outputs) — typos and gaps fail loudly."""
        points = [t.name for t in graph.annotation_points()]
        missing = [n for n in points if n not in self.annots]
        if missing:
            raise StrategyError(
                f"strategy {self.name!r} misses annotations for "
                f"{missing}; annotation points are {points}")
        extra = [n for n in self.annots if n not in points]
        if extra:
            raise StrategyError(
                f"strategy {self.name!r} annotates unknown tensors {extra}; "
                f"annotation points are {points}")


# ---------------------------------------------------------------------------
# convenience constructors
# ---------------------------------------------------------------------------

def weights_graph(shapes: Mapping[str, Sequence[int]]) -> Graph:
    """A parameters-only graph — the weight-migration view that elastic
    training and serving reshard (paper §6.2)."""
    g = Graph()
    for name, shape in shapes.items():
        g.parameter(name, tuple(shape))
    return g


def data_parallel_strategy(name: str, devices: Sequence[int],
                           shapes: Mapping[str, Sequence[int]],
                           shard_dim: int = 0,
                           topology: Topology | None = None) -> Strategy:
    """FSDP-style placement: each tensor split along ``shard_dim`` over
    the largest trailing subset of ``devices`` that divides it (falling
    back to a single-device replica) — the elastic-training layout."""
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise StrategyError(f"strategy {name!r}: empty device list")
    annots = {}
    for tname, shape in shapes.items():
        if len(shape) <= shard_dim:
            annots[tname] = spmd(devices[:1], DS({}))
            continue
        size = int(shape[shard_dim])
        for k in (n, n - n % 2, 4, 2, 1):
            if k and k <= n and size % k == 0:
                # survivors with the highest ids host the shards, so a
                # shrinking cluster actually moves data (SR/BSR paths)
                annots[tname] = spmd(devices[-k:], DS({shard_dim: k}))
                break
        else:
            annots[tname] = spmd(devices[:1], DS({}))
    return Strategy(name, annots, topology)
