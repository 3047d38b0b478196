"""Gaussian-sharded rendering and training over ``torch.distributed`` (port
of ``tdgs/parallel/``).

The JAX package runs one controller over a device mesh; the port runs one
process per rank (``launch.run``, or ``python -m torch.distributed.run``),
each holding a block of the gaussian rows and of the cameras. ``mesh``
joins the world and names its axes (and chooses the backend), ``comm``
holds the differentiable collectives, ``sharded_render`` the renders,
``checkpoint`` the sharded checkpoint of ``Config.sharded`` training.
"""

from tdgs_torch.parallel.mesh import make_mesh
from tdgs_torch.parallel.sharded_render import (
    rasterization_2dgs_sharded,
    rasterization_eval3d_sharded,
    rasterization_replicated,
    rasterization_sharded,
)

__all__ = [
    "make_mesh",
    "rasterization_2dgs_sharded",
    "rasterization_replicated",
    "rasterization_eval3d_sharded",
    "rasterization_sharded",
]
