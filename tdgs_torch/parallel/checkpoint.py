"""The sharded checkpoint: the port's ``ckpt_format="orbax"`` (the JAX
``Runner``'s directory container, ``tdgs/training/trainer.py:1444-1462``
save and :1569-1590 load).

orbax imports JAX, so the port writes its directory with
``torch.distributed.checkpoint``: every rank saves its own block of each
per-gaussian array (``parallel.rows``) as a ``DTensor`` sharded on its
leading axis, and one copy of everything else, under the JAX package's keys
(``step``, ``splats``, ``opt_state``, ``strategy_state``,
``segmentation_head``). This is not orbax's on-disk format: a JAX orbax
checkpoint is not read here, nor this one by the JAX package. A load on a
world of another size re-blocks the rows (``torch.distributed.checkpoint``
reads each rank's new block from the saved blocks it overlaps); a load
without a world reads the whole arrays.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from tdgs_torch._device import DeviceLike, resolve_device
from tdgs_torch.parallel.mesh import Mesh
from tdgs_torch.parallel.rows import is_rows

ROWS_KEY = "splats.means"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if "." in k:
            raise ValueError(f"checkpoint key {k!r} holds a '.'")
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _device_mesh(mesh: Mesh) -> DeviceMesh:
    return DeviceMesh(mesh.device.type, list(range(mesh.world)))


def save(path: str, state: Dict[str, Any], capacity: int,
         mesh: Optional[Mesh] = None) -> str:
    """Write ``state`` (this rank's blocks of the per-gaussian arrays, of a
    global ``capacity`` rows; one copy of the rest) to the directory
    ``path``, replacing it. Without ``mesh`` the arrays are whole. A
    collective call under a mesh."""
    if mesh is None or mesh.rank == 0:
        if os.path.exists(path):
            shutil.rmtree(path)
    if mesh is not None:
        dist.barrier()
    flat = _flatten(state)
    if mesh is not None:
        dm = _device_mesh(mesh)
        n = capacity // mesh.world
        for k, v in flat.items():
            if isinstance(v, torch.Tensor) and is_rows(k.split("."), v.dim()):
                if v.shape[0] != n:
                    raise ValueError(f"{k}: {v.shape[0]} rows, not the block of {n}")
                flat[k] = DTensor.from_local(v.contiguous(), dm, [Shard(0)], run_check=False,
                                             shape=(capacity,) + tuple(v.shape[1:]),
                                             stride=v.contiguous().stride())
    dcp.save(flat, checkpoint_id=path, no_dist=mesh is None)
    return path


def load(path: str, mesh: Optional[Mesh] = None,
         device: DeviceLike = None) -> Dict[str, Any]:
    """The state saved at ``path``: under ``mesh`` each per-gaussian array
    as this rank's block of the saved capacity (which must divide over the
    world), else whole; on ``device`` (default: the mesh's, else the card;
    ``"cpu"`` for the CPU). A collective call under a mesh."""
    device = mesh.device if device is None and mesh is not None else resolve_device(device)
    md = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    capacity = md[ROWS_KEY].size[0]
    if mesh is not None and capacity % mesh.world:
        raise ValueError(f"capacity {capacity} does not divide over {mesh.world} ranks")
    dm = None if mesh is None else _device_mesh(mesh)
    flat: Dict[str, Any] = {}
    for key, m in md.items():
        if not isinstance(m, TensorStorageMetadata):
            flat[key] = None  # a pickled value: filled in by the load
            continue
        size, dtype = tuple(m.size), m.properties.dtype
        if dm is not None and is_rows(key.split("."), len(size)):
            n = capacity // mesh.world
            local = torch.zeros((n,) + size[1:], dtype=dtype, device=device)
            flat[key] = DTensor.from_local(local, dm, [Shard(0)], run_check=False,
                                           shape=size, stride=local.stride())
        else:
            flat[key] = torch.zeros(size, dtype=dtype, device=device)
    dcp.load(flat, checkpoint_id=path, no_dist=mesh is None)
    flat = {k: v.to_local() if isinstance(v, DTensor) else v for k, v in flat.items()}
    return _unflatten(flat)
