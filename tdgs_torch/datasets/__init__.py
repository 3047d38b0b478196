"""Data layer: COLMAP parsing, world normalization and camera trajectories
(numpy copies of the JAX package's ``tdgs/datasets``), and the decode-ahead
of the training images (``prefetch.py``)."""

from tdgs_torch.datasets.colmap import Dataset, Parser
from tdgs_torch.datasets.normalize import (
    align_principal_axes,
    similarity_from_cameras,
    transform_cameras,
    transform_points,
)

__all__ = [
    "Parser",
    "Dataset",
    "similarity_from_cameras",
    "align_principal_axes",
    "transform_cameras",
    "transform_points",
]
