"""The rank mesh of the multi-process runtime (``torch.distributed``).

The counterpart of ``repro/launch/mesh.py:make_runtime_mesh``: where the
reference lays a 1-D ``jax.sharding.Mesh`` over host devices, the port
lays one axis over the ranks of the world process group.  Position ``i``
of a plan's or graph's ``DeviceOrder`` (the HSPMD logical device ids,
sorted) is rank ``i``, as it is mesh position ``i`` in the reference.

Backends are chosen explicitly, and nothing switches to another backend or
device on its own:

* ``"nccl"``: every rank on its own GPU (``cuda:rank``); needs
  ``torch.cuda.device_count() >= world_size`` and raises otherwise (NCCL
  refuses two ranks on one GPU),
* ``"gloo"`` with ``device="cuda"``: rank ``r`` on ``cuda:(r % count)``, so
  several ranks may share one GPU; gloo moves only CPU tensors, so every
  payload is staged through host memory (``RankMesh.staged``),
* ``"gloo"`` with ``device="cpu"``: every rank on the CPU,
* ``None``: ``"nccl"`` when the GPUs suffice, raising when they do not
  (pass ``backend="gloo"`` to share a GPU); on the CPU, ``"gloo"``, the
  only CPU backend.

The reference's production and test meshes over TPU chips are here as
logical meshes (:class:`LogicalMesh`: axis names, sizes, device ids; no
device state): :func:`make_production_mesh` and :func:`make_smoke_mesh`.
A logical mesh becomes a ``DeviceMesh`` over a fake world of its size for
the dry run (:meth:`LogicalMesh.device_mesh`), or one process group per
row of each axis over real ranks (:meth:`LogicalMesh.rank_groups`).

A process group that :func:`make_runtime_mesh` initializes is destroyed
when the rank's interpreter exits (:func:`_teardown_at_exit`): a gloo group
left to the interpreter's own shutdown can abort the rank there.
"""

from __future__ import annotations

import atexit
import faulthandler
import os
import sys
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

#: the environment variable that carries the rendezvous URL
#: (``file://...`` or ``tcp://host:port``) to a rank; without it the
#: process group initializes from ``env://`` (``MASTER_ADDR`` /
#: ``MASTER_PORT``, as under ``torchrun``)
INIT_ENV = "REPRO_DIST_INIT"
#: seconds the exit-time teardown of a rank's process group may take;
#: past them the rank prints its threads' stacks and exits with code 1
TEARDOWN_TIMEOUT = 30.0


@dataclass
class RankMesh:
    """One axis over the world's ranks, seen from this rank."""

    rank: int
    world: int
    backend: str
    #: each rank's torch device, by rank
    devices: tuple[torch.device, ...]
    #: payloads cross host memory (gloo moving CUDA tensors)
    staged: bool
    _groups: dict = field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    def logical_device(self, order) -> int | None:
        """The logical device of ``order`` this rank holds, or ``None``
        when the order spans fewer devices than there are ranks."""
        return order.devices[self.rank] if self.rank < len(order) else None

    def check_span(self, n_logical: int) -> None:
        """Raise when a plan or graph spans more logical devices than the
        mesh has ranks."""
        if self.world < n_logical:
            raise ValueError(
                f"plan spans {n_logical} logical devices but mesh has only "
                f"{self.world} ranks; start more ranks (e.g. "
                f"repro_torch.runtime.harness.run_ranks(..., "
                f"n_ranks={n_logical}))")

    def group(self, members) -> "dist.ProcessGroup | None":
        """The process group over ``members`` (ranks), made on first use
        and cached by its member tuple.  ``dist.new_group`` is collective
        over the world: every rank must ask for the same groups in the
        same order, which lowering a plan on every rank does.  The whole
        world is the default group (``None``)."""
        key = tuple(sorted(members))
        if len(key) == self.world:
            return None
        if key not in self._groups:
            self._groups[key] = dist.new_group(list(key))
        return self._groups[key]


def _world_size(n_ranks: int | None) -> int:
    if dist.is_initialized():
        world = dist.get_world_size()
    elif "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
    elif n_ranks is not None:
        world = n_ranks
    else:
        raise RuntimeError(
            "no process group and no WORLD_SIZE in the environment: start "
            "the ranks with repro_torch.runtime.harness.run_ranks (or "
            "torchrun)")
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"asked for {n_ranks} ranks but the world has "
                         f"{world}")
    return world


def _teardown_at_exit() -> None:
    """Destroy the world group (and every subgroup) as the rank exits.
    Left to the interpreter's shutdown, gloo's threads can be torn down
    while still joinable, and the rank aborts with SIGABRT ("terminate
    called without an active exception") after its work is done.  After
    an uncaught exception the rank waits on nothing: its peers may be
    inside an exchange with it, so it exits with code 1 at once and
    ``run_ranks`` stops the others.  A teardown that takes longer than
    :data:`TEARDOWN_TIMEOUT` exits with code 1 as well."""
    if not dist.is_initialized():
        return
    if getattr(sys, "last_exc", None) is not None:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    faulthandler.dump_traceback_later(TEARDOWN_TIMEOUT, exit=True)
    try:
        dist.destroy_process_group()
    finally:
        faulthandler.cancel_dump_traceback_later()


def choose_backend(backend: str | None, device_type: str, world: int) -> str:
    """The process-group backend for ``world`` ranks on ``device_type``,
    raising where the request cannot be met."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; use 'nccl' or "
                         f"'gloo'")
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("backend 'nccl' moves CUDA tensors only; use "
                             "backend='gloo' on the CPU")
        return "gloo"
    if backend == "gloo":
        return backend
    if count < world:
        raise RuntimeError(
            f"backend 'nccl' needs a GPU per rank: {world} ranks, {count} "
            f"visible GPU(s); pass backend='gloo' to share a GPU between "
            f"ranks (payloads are then staged through host memory)")
    return "nccl"


def make_runtime_mesh(n_ranks: int | None = None, *,
                      backend: str | None = None,
                      device=None) -> RankMesh:
    """1-D mesh over the ranks of the world group, initializing the group
    from the environment (``RANK``, ``WORLD_SIZE`` and the rendezvous in
    ``REPRO_DIST_INIT``; see ``runtime.harness.rank_env``) unless it is
    initialized already; a group initialized here is destroyed when the
    process exits (:func:`_teardown_at_exit`).  ``n_ranks``, when given,
    must equal the world size.  ``device=None`` means ``cuda``."""
    from repro_torch.device import resolve_device

    world = _world_size(n_ranks)
    dev_type = torch.device("cuda" if device is None else device).type
    chosen = choose_backend(backend, dev_type, world)
    rank = dist.get_rank() if dist.is_initialized() \
        else int(os.environ.get("RANK", "0"))
    if dev_type == "cuda":
        resolve_device("cuda")        # raises without a GPU; TF32 off
        count = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", r % count)
                        for r in range(world))
        torch.cuda.set_device(devices[rank])
    else:
        devices = tuple(resolve_device("cpu") for _ in range(world))
    if dist.is_initialized():
        if dist.get_backend() != chosen:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()!r}, not "
                f"{chosen!r}")
    else:
        kw = {"device_id": devices[rank]} if chosen == "nccl" else {}
        dist.init_process_group(
            chosen, init_method=os.environ.get(INIT_ENV, "env://"),
            rank=rank, world_size=world, **kw)
        atexit.register(_teardown_at_exit)
    mesh = RankMesh(rank, world, chosen, devices,
                    staged=chosen == "gloo" and dev_type == "cuda")
    # one world collective before any point-to-point call (NCCL's first
    # P2P call on a communicator must include every rank)
    dist.barrier(**({"device_ids": [devices[rank].index]}
                    if chosen == "nccl" else {}))
    return mesh


# ---------------------------------------------------------------------------
# logical meshes (the reference's production and smoke meshes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LogicalMesh:
    """Named axes over ``size`` devices, numbered row-major (the last axis
    minor), as ``np.array(devices).reshape(shape)`` lays out the
    reference's ``jax.sharding.Mesh``.  ``shape`` maps each axis name to its
    size, as a JAX mesh's does; nothing here touches a device."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def devices(self) -> np.ndarray:
        """Device ids (ranks) laid out in the mesh's shape."""
        return np.arange(self.size).reshape(self.axis_sizes)

    def label(self) -> str:
        return "x".join(str(n) for n in self.axis_sizes)

    def device_mesh(self, device_type: str = "cpu"):
        """A ``DeviceMesh`` of this shape and these axis names over the
        world process group, which must have ``size`` ranks (the dry run's
        fake world)."""
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized() or dist.get_world_size() != self.size:
            raise RuntimeError(
                f"a {self.label()} DeviceMesh needs a world of {self.size} "
                f"ranks")
        return init_device_mesh(device_type, self.axis_sizes,
                                mesh_dim_names=self.axis_names)

    def rank_groups(self, ranks: "RankMesh") -> dict[str, object]:
        """For each axis, the process group of this rank's row along it
        (the ranks that differ from this one in that axis alone).  Every
        rank makes every row's group, in one order, as ``dist.new_group``
        asks; ``None`` stands for the whole world."""
        if ranks.world != self.size:
            raise ValueError(f"a {self.label()} mesh needs {self.size} "
                             f"ranks, the world has {ranks.world}")
        ids = self.devices
        out = {}
        for d, name in enumerate(self.axis_names):
            rows = np.moveaxis(ids, d, -1).reshape(-1, self.axis_sizes[d])
            for row in rows:
                group = ranks.group(row.tolist())
                if ranks.rank in row:
                    out[name] = group
        return out

    def coords(self, rank: int) -> dict[str, int]:
        """This rank's position along each axis."""
        idx = np.unravel_index(rank, self.axis_sizes)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """Single pod: (data=16, model=16) = 256 devices; multi-pod:
    (pod=2, data=16, model=16) = 512, the ``pod`` axis carrying cross-pod
    data parallelism: the reference's shapes (``repro/launch/mesh.py``)."""
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    return LogicalMesh(("data", "model"), (16, 16))


def make_smoke_mesh(n_devices: int | None = None,
                    axes=("data", "model")) -> LogicalMesh:
    """A tiny mesh: (1, n) over two axes, or (n,) over one.  ``n`` defaults
    to 1, the one device a process of the port drives."""
    n = n_devices or 1
    shape = (1, n) if len(axes) == 2 else (n,)
    return LogicalMesh(tuple(axes), shape)
