"""GPU constants and the per-device counter of the dry run: the PyTorch
counterpart of ``repro/launch/hloparse.py``.

Where the reference parses the partitioned HLO text for its collectives
and takes FLOPs and bytes from XLA's cost analysis, the port runs the step
once on fake tensors and counts what each device's program does:
:class:`DeviceCounter` is a ``TorchDispatchMode`` that lets DTensor lower
each op to the local ops and functional collectives of one device (rank 0
of the fake world) and counts those.

Card constants are looked up by the name ``torch.cuda.get_device_name()``
or ``nvidia-smi`` gives, or by a short key (``--gpu``); an unknown card
raises.  Nothing guesses a card.
"""

from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclass(frozen=True)
class Gpu:
    key: str
    name: str                 # torch.cuda.get_device_name()
    #: dense peak FLOP/s by the matmul inputs' dtype: bf16 / fp16 on the
    #: tensor cores, fp32 outside them (TF32 stays off in the port)
    peak_flops: dict
    hbm_bw: float             # bytes/s
    hbm_bytes: float          # device memory
    node_gpus: int            # GPUs joined all to all by NVLink
    nvlink_bw: float          # bytes/s a direction, inside a node
    network_bw: float         # bytes/s a direction per GPU, across nodes


#: NVIDIA H100 SXM5 80 GB (data sheet, dense): 989 TFLOP/s bf16, 67 fp32,
#: 3.35 TB/s HBM3; NVLink 4 at 900 GB/s both ways (450 a direction) inside
#: an 8-GPU HGX node; across nodes one 400 Gb/s NDR InfiniBand port per
#: GPU (50 GB/s a direction), as a DGX H100 has
H100_SXM = Gpu(key="h100-sxm", name="NVIDIA H100 80GB HBM3",
               peak_flops={"bfloat16": 989e12, "float16": 989e12,
                           "float32": 67e12},
               hbm_bw=3.35e12, hbm_bytes=80e9, node_gpus=8,
               nvlink_bw=450e9, network_bw=50e9)

GPUS = {g.key: g for g in (H100_SXM,)}


def get_gpu(name: str) -> Gpu:
    """The constants of the card called ``name`` (a key of :data:`GPUS` or
    the device's own name); raises for any other."""
    for g in GPUS.values():
        if name in (g.key, g.name):
            return g
    raise KeyError(f"unknown GPU {name!r}: no constants for it; known: "
                   + ", ".join(f"{g.key} ({g.name})" for g in GPUS.values()))


def axis_links(mesh, gpu: Gpu) -> dict[str, tuple[str, float]]:
    """Which link each mesh axis's collectives cross, and its rate: an
    axis whose every row of devices lies in one NVLink node (devices
    numbered row-major, ``node_gpus`` consecutive ids a node) runs over
    NVLink; any other crosses the network.  On (data=16, model=16) both
    axes cross it: a ``model`` row spans two 8-GPU nodes, a ``data`` row
    sixteen."""
    ids = mesh.devices
    out = {}
    for d, name in enumerate(mesh.axis_names):
        rows = np.moveaxis(ids, d, -1).reshape(-1, mesh.axis_sizes[d])
        inside = all(len(set((r // gpu.node_gpus).tolist())) == 1
                     for r in rows)
        out[name] = (("nvlink", gpu.nvlink_bw) if inside
                     else ("network", gpu.network_bw))
    return out


# ---------------------------------------------------------------------------
# the per-device counter
# ---------------------------------------------------------------------------

_c10d = torch.ops._c10d_functional
#: functional collective -> (the reference's HLO kind, index of its
#: group-name argument)
COLLECTIVES = {
    _c10d.all_reduce.default: ("all-reduce", 2),
    _c10d.all_reduce_.default: ("all-reduce", 2),
    _c10d.all_gather_into_tensor.default: ("all-gather", 2),
    _c10d.reduce_scatter_tensor.default: ("reduce-scatter", 3),
    _c10d.all_to_all_single.default: ("all-to-all", 3),
}
_SKIP = {_c10d.wait_tensor.default}
_aten = torch.ops.aten
#: ops that make a tensor without reading or writing its memory
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like,
               _aten.new_empty, _aten.new_empty_strided}


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagation is running: it runs each new
    op once on fake tensors of the global shapes to learn the output's
    shape, which no device holds or computes."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


def _tensors(tree):
    out = []

    def rec(t):
        if isinstance(t, (list, tuple)):
            for v in t:
                rec(v)
        elif isinstance(t, dict):
            for v in t.values():
                rec(v)
        elif torch.is_tensor(t):
            out.append(t)
    rec(tree)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class DeviceCounter(TorchDispatchMode):
    """What one device's program does, op by op: matmul FLOPs by dtype
    (``torch.utils.flop_counter``'s formulas), HBM bytes (each op's tensor
    inputs read once and outputs written once, views and collectives
    excepted: eager, unfused, so an upper bound on a fused program's),
    collective result bytes by kind and by mesh axis, and the memory that
    is live: every storage an op makes counts from then until it is freed
    (a weak reference), so autograd's saved tensors count as long as they
    are kept, as on the card.  Tensors that exist before the counted code
    runs count only when :meth:`track` is given them (the step's
    arguments).

    ``axis_of_group`` maps a process group's name to its mesh axis and
    size.  DTensor ops pass through (``NotImplemented``) so that DTensor lowers
    them to the local ops and collectives this counter sees, as
    ``CommDebugMode`` does."""

    def __init__(self, axis_of_group: dict[str, tuple] | None = None,
                 fake_mode=None):
        super().__init__()
        #: when set, only ops whose outputs are this mode's fake tensors
        #: count
        self.fake_mode = fake_mode
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.axis_of_group = dict(axis_of_group or {})
        self.flops: dict[str, float] = defaultdict(float)
        self.hbm_bytes = 0.0
        self.collectives: dict[str, float] = defaultdict(float)
        self.collectives_by_axis: dict[str, float] = defaultdict(float)
        self.live = 0
        self.peak = 0
        self.arguments = 0
        #: op name -> [calls, HBM bytes, largest output bytes]
        self.by_op: dict[str, list] = defaultdict(lambda: [0, 0.0, 0])
        self._seen: dict[int, int] = {}

    # -- memory ------------------------------------------------------------
    def _add_storage(self, t) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return 0
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key):
        self.live -= self._seen.pop(key, 0)

    def track(self, tree) -> int:
        """Count the tensors of ``tree`` (DTensors by their local shards) as
        live arguments; returns their bytes."""
        from torch.distributed.tensor import DTensor
        n = 0
        for t in _tensors(tree):
            n += self._add_storage(t.to_local() if isinstance(t, DTensor)
                                   else t)
        self.arguments += n
        return n

    def reset_peak(self) -> None:
        self.peak = self.live

    # -- ops ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _SKIP:
            return out
        outs = _tensors(out)
        if not outs or (self.fake_mode is not None and any(
                getattr(t, "fake_mode", None) is not self.fake_mode
                for t in outs)) or _in_sharding_propagation():
            return out
        coll = COLLECTIVES.get(func)
        if coll is not None:
            kind, gi = coll
            group = args[gi] if len(args) > gi else kwargs.get("group_name")
            axis, size = self.axis_of_group.get(group, ("?", 2))
            if size > 1:    # a group of one rank moves nothing
                nb = sum(_nbytes(t) for t in outs)
                self.collectives[kind] += nb
                self.collectives_by_axis[axis] += nb
        else:
            packet = func._overloadpacket
            if packet in self._flop_registry:
                ins = _tensors(args)
                dt = str(ins[0].dtype).replace("torch.", "") if ins else "?"
                self.flops[dt] += self._flop_registry[packet](
                    *args, **kwargs, out_val=out)
            aliasing = any(r.alias_info is not None
                           for r in func._schema.returns)
            if not aliasing and packet not in _NO_TRAFFIC:
                nb = sum(_nbytes(t) for t in _tensors(args)) \
                    + sum(_nbytes(t) for t in outs)
                self.hbm_bytes += nb
                rec = self.by_op[str(packet)]
                rec[0] += 1
                rec[1] += nb
                rec[2] = max(rec[2], max((_nbytes(t) for t in outs),
                                         default=0))
        for t in outs:
            self._add_storage(t)
        return out

    # -- report ------------------------------------------------------------
    def totals(self) -> dict:
        return {"peak_bytes": self.peak, "argument_bytes": self.arguments,
                "flops": float(sum(self.flops.values())),
                "flops_by_dtype": dict(self.flops),
                "hbm_bytes": float(self.hbm_bytes),
                "collective_bytes": float(sum(self.collectives.values())),
                "collectives": collective_bytes(self),
                "collectives_by_axis": dict(self.collectives_by_axis)}


def roofline_terms(costs: dict, gpu: Gpu, links: dict) -> dict[str, float]:
    """Seconds for the compute, memory and collective terms of ``costs``
    (a :meth:`DeviceCounter.totals`): FLOPs at each dtype's peak, HBM bytes
    at the HBM rate, each axis's collective bytes at its link's rate
    (:func:`axis_links`)."""
    compute = sum(f / gpu.peak_flops.get(dt, gpu.peak_flops["float32"])
                  for dt, f in costs["flops_by_dtype"].items())
    coll = sum(b / links.get(ax, ("network", gpu.network_bw))[1]
               for ax, b in costs["collectives_by_axis"].items())
    return {"compute": compute, "memory": costs["hbm_bytes"] / gpu.hbm_bw,
            "collective": coll}


def collective_bytes(counter: DeviceCounter) -> dict[str, int]:
    """Result bytes of every collective by kind, the counterpart of the
    reference's ``collective_bytes(hlo_text)``."""
    return {k: int(v) for k, v in counter.collectives.items()}
