"""Cluster topology / bandwidth models for BSR planning (paper §4.3).

The paper's BSR heuristic 2 prefers the highest-bandwidth link between an
owner and a receiver; heuristic 3 balances cumulative send load.  Both need
a topology oracle.  We provide:

* :class:`NvlinkIbTopology` — the paper's own cluster shape (Appendix A.1):
  nodes of ``gpus_per_node`` GPUs joined by NVLink, nodes joined by
  InfiniBand.  Used to reproduce Table 2 / Fig 18.

* :class:`TpuTorusTopology` — the TPU-native adaptation: a 2D ICI torus per
  pod (wraparound links, ~50 GB/s per link) with DCN across pods.  Distance
  is ICI hop count; bandwidth decays with hops (store-and-forward shares
  links), and cross-pod traffic rides the much slower DCN.

* :class:`UniformTopology` — equal bandwidth everywhere (degenerate case;
  makes heuristic 2 a no-op so heuristic 3 dominates — used in tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class Topology:
    def bandwidth(self, src: int, dst: int) -> float:  # GB/s
        raise NotImplementedError

    def time_for(self, src: int, dst: int, nbytes: int) -> float:
        if src == dst:
            return 0.0
        return nbytes / (self.bandwidth(src, dst) * 1e9)


@dataclass(frozen=True)
class UniformTopology(Topology):
    gbps: float = 100.0

    def bandwidth(self, src: int, dst: int) -> float:
        return self.gbps


@dataclass(frozen=True)
class NvlinkIbTopology(Topology):
    """Paper Appendix A.1-style cluster: NVLink within a node, IB across."""

    gpus_per_node: int = 8
    nvlink_gbps: float = 400.0  # H800 NVLink from Table 3
    ib_gbps: float = 25.0       # typical 200 Gb/s HCA per GPU
    # optional per-node NVLink override (e.g. H20 nodes have 900 GB/s)
    node_nvlink_gbps: dict[int, float] = field(default_factory=dict)

    def node_of(self, dev: int) -> int:
        return dev // self.gpus_per_node

    def bandwidth(self, src: int, dst: int) -> float:
        if self.node_of(src) == self.node_of(dst):
            return self.node_nvlink_gbps.get(self.node_of(src), self.nvlink_gbps)
        return self.ib_gbps


@dataclass(frozen=True)
class TpuTorusTopology(Topology):
    """TPU pod: chips on an X x Y torus (per pod), pods joined by DCN.

    ``bandwidth(src, dst)`` models effective point-to-point throughput as
    link_gbps / hops (a message consumes every link on its minimal path),
    which preserves the *ordering* the BSR heuristics need: neighbors beat
    far chips beat cross-pod.
    """

    torus_x: int = 16
    torus_y: int = 16
    link_gbps: float = 50.0   # per ICI link
    dcn_gbps: float = 6.25    # per-chip share of cross-pod DCN

    @property
    def chips_per_pod(self) -> int:
        return self.torus_x * self.torus_y

    def pod_of(self, dev: int) -> int:
        return dev // self.chips_per_pod

    def coords(self, dev: int) -> tuple[int, int]:
        local = dev % self.chips_per_pod
        return local // self.torus_y, local % self.torus_y

    def hops(self, src: int, dst: int) -> int:
        (x0, y0), (x1, y1) = self.coords(src), self.coords(dst)
        dx = abs(x0 - x1)
        dy = abs(y0 - y1)
        return min(dx, self.torus_x - dx) + min(dy, self.torus_y - dy)

    def bandwidth(self, src: int, dst: int) -> float:
        if self.pod_of(src) != self.pod_of(dst):
            return self.dcn_gbps
        h = self.hops(src, dst)
        return self.link_gbps if h <= 1 else self.link_gbps / h
