"""Run a function of the port on W ranks, one process each.

``run(fn, world_size, *args, device=None)`` spawns W processes with
``torch.multiprocessing``, joins them into one world over a ``FileStore``
in a temporary directory (a file needs no port, so concurrent worlds on
one machine cannot clash), calls ``fn(*args)`` on every rank and returns
the ranks' return values in rank order. ``fn`` must be a module-level
function that a fresh interpreter can import by its module: a spawned
child unpickles it by name. The world is bounded by ``timeout_s``: a rank
that hangs in a collective makes ``run`` raise after that long, and every
process it started is ended.

Under PyTorch's own launcher (``python -m torch.distributed.run
--nproc-per-node W -m tdgs_torch.simple_trainer ... --sharded``) the ranks
join through ``mesh.initialize_multihost`` instead, from the environment.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tdgs_torch._device import DeviceLike, resolve_device
from tdgs_torch.parallel import mesh as mesh_mod


def _rank_main(rank: int, fn: Callable, world_size: int, store_path: str, out_dir: str,
               device: DeviceLike, timeout_s: float, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world_size)))
    store = dist.FileStore(store_path, world_size)
    mesh_mod.initialize(device, rank=rank, world_size=world_size, store=store,
                        timeout_s=timeout_s)
    try:
        out = fn(*args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn: Callable, world_size: int, *args: Any, device: DeviceLike = None,
        timeout_s: float = 300.0) -> List[Any]:
    """``fn(*args)`` on each of ``world_size`` ranks on ``device``: the card
    by default, rank r on ``cuda:{r % device_count}`` (raises without one);
    ``device="cpu"`` joins the ranks over gloo on the CPU. Returns the
    ranks' results; raises when a rank raises or the world outlasts
    ``timeout_s``."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="tdgs_world_") as tmp:
        store_path = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, store_path, tmp, device, timeout_s, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"world of {world_size} ranks running {fn.__name__} "
                                       f"did not end within {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
