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

``make_production_mesh`` and ``make_smoke_mesh`` (the reference's
production and test meshes over TPU chips) have no counterpart yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

#: the environment variable that carries the rendezvous URL
#: (``file://...`` or ``tcp://host:port``) to a rank; without it the
#: process group initializes from ``env://`` (``MASTER_ADDR`` /
#: ``MASTER_PORT``, as under ``torchrun``)
INIT_ENV = "REPRO_DIST_INIT"


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
    initialized already.  ``n_ranks``, when given, must equal the world
    size.  ``device=None`` means ``cuda``."""
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
    mesh = RankMesh(rank, world, chosen, devices,
                    staged=chosen == "gloo" and dev_type == "cuda")
    # one world collective before any point-to-point call (NCCL's first
    # P2P call on a communicator must include every rank)
    dist.barrier(**({"device_ids": [devices[rank].index]}
                    if chosen == "nccl" else {}))
    return mesh
