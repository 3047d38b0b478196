"""The world of ranks and its named axes (port of ``tdgs/parallel/mesh.py``:
``make_mesh`` :18, ``initialize_multihost`` :27).

The JAX package runs one controller that sees every device and lays arrays
out over a ``jax.sharding.Mesh``. The port runs one process per rank, the
model of the reference gsplat (``tdgs/parallel/comm.py:1-13``): every rank
joins one ``torch.distributed`` world, and a :class:`Mesh` names the process
group of each axis that holds this rank.

The backend is chosen here and nowhere else (``choose_backend``):

- NCCL where every rank of the host has a card of its own;
- gloo where ranks share a card: NCCL refuses two ranks on one device
  ("Duplicate GPU detected");
- gloo on the CPU.

Neither backend ever gives way to the other when one fails.
"""

from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from tdgs_torch._device import DeviceLike, resolve_device

# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 600


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` as
    ``torch.distributed.run`` (and ``parallel.launch``) set it, else the
    global rank."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def local_world_size() -> int:
    """The ranks on this host: ``LOCAL_WORLD_SIZE``, else the world."""
    default = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", default))


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device of this rank: ``cuda:{local_rank % device_count}`` unless
    ``device`` is the CPU. Without a card, CUDA raises (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def choose_backend(device: DeviceLike = None, n_local: Optional[int] = None) -> str:
    """The written rule: "nccl" when the ranks run on cards and every one of
    the ``n_local`` ranks of this host has a card of its own, else "gloo"."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo"
    n_local = local_world_size() if n_local is None else n_local
    return "nccl" if n_local <= torch.cuda.device_count() else "gloo"


def initialize(device: DeviceLike = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, store: Optional[dist.Store] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the world (no-op when this process has joined it) and return
    the backend. Without ``store`` the rank, the world size and the
    rendezvous come from the environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), as ``torch.distributed.run`` sets
    them. On a card the process's current device is set to the rank's."""
    if dist.is_initialized():
        return dist.get_backend()
    backend = choose_backend(device)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw.update(store=store, rank=rank, world_size=world_size)
    else:
        kw.update(init_method="env://")
        if rank is not None:
            kw.update(rank=rank, world_size=world_size)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return backend


def initialize_multihost(device: DeviceLike = None) -> str:
    """Join the world described by the environment (``initialize``): the
    port's counterpart of ``jax.distributed.initialize``. A process started
    without ``torch.distributed.run`` (no ``WORLD_SIZE``) joins a world of
    one through a store of its own."""
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return initialize(device)
    return initialize(device, rank=0, world_size=1, store=dist.HashStore())


@dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over the world: ``shape`` (axis → size, row-major over
    the ranks, as ``np.array(devices).reshape(shape)`` in the JAX package),
    ``groups`` (axis → the process group of the ranks that differ from this
    one only on that axis), ``coords`` (axis → this rank's index on it), the
    global ``rank`` and ``world``, this rank's ``device`` and the
    ``backend``."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    groups: Dict[str, dist.ProcessGroup]
    coords: Dict[str, int]
    rank: int
    world: int
    device: torch.device
    backend: str

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> dist.ProcessGroup:
        return self.groups[axis]


def make_mesh(axis_name: Union[str, Sequence[str]] = "gauss",
              shape: Optional[Sequence[int]] = None, device: DeviceLike = None) -> Mesh:
    """The mesh of the joined world (``initialize`` first). One axis
    ``axis_name`` over every rank by default, as the JAX package's default
    mesh is every device; several names with ``shape`` lay the ranks out
    row-major, e.g. ``make_mesh(("frame", "gauss"), (2, 2))``. A collective
    call: every rank makes every group, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a joined world: call parallel.mesh.initialize "
                           "(or run under torch.distributed.run / parallel.launch)")
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = (world,) if shape is None else tuple(int(s) for s in shape)
    if len(sizes) != len(names) or math.prod(sizes) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} does not cover {world} ranks")
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    coords = {n: (rank // st) % sz for n, st, sz in zip(names, strides, sizes)}
    groups = {}
    for a, (name, st, sz) in enumerate(zip(names, strides, sizes)):
        if sz == world:
            groups[name] = dist.group.WORLD
            continue
        # one group per line along this axis; every rank creates them all
        for base in range(world):
            if (base // st) % sz:
                continue  # not the first rank of its line
            members = [base + i * st for i in range(sz)]
            g = dist.new_group(members)
            if rank in members:
                groups[name] = g
    return Mesh(names, dict(zip(names, sizes)), groups, coords, rank, world,
                rank_device(device), dist.get_backend())
