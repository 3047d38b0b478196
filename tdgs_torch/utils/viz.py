"""Colour maps and image saving for the trainer's dumps (numpy port of
``tdgs/utils/viz.py``: ``apply_float_colormap``, ``apply_depth_colormap``,
``save_image``).

Neither matplotlib nor PIL is needed: the ``turbo`` table is a constant
(``_turbo.py``) and images go through ``utils/png.write_png``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from tdgs_torch.utils._turbo import TURBO
from tdgs_torch.utils.png import write_png

_TABLES = {"turbo": TURBO}


def apply_float_colormap(img: np.ndarray, colormap: str = "turbo") -> np.ndarray:
    """[..., 1] float in [0, 1] → [..., 3] float colours in [0, 1]; NaN
    reads as 0. ``colormap`` is "turbo" or "gray"."""
    img = np.nan_to_num(np.asarray(img), nan=0.0)
    if colormap == "gray":
        return np.repeat(img, 3, axis=-1)
    if colormap not in _TABLES:
        raise ValueError(f"colormap {colormap!r}: the port carries {sorted(_TABLES)} "
                         "and 'gray'")
    img_long = (img * 255).astype(np.int64)
    if img_long.size and (img_long.min() < 0 or img_long.max() > 255):
        raise ValueError(f"values outside [0, 1]: {img.min()} .. {img.max()}")
    return _TABLES[colormap][img_long[..., 0]]


def apply_depth_colormap(
    depth: np.ndarray,
    acc: Optional[np.ndarray] = None,
    near_plane: Optional[float] = None,
    far_plane: Optional[float] = None,
) -> np.ndarray:
    """[..., 1] depth → [..., 3] turbo colours of the depth scaled to
    [near, far] (default its min and max); with ``acc`` the colours blend
    toward white where the accumulation is low."""
    depth = np.asarray(depth, np.float32)
    near_plane = near_plane if near_plane is not None else float(depth.min())
    far_plane = far_plane if far_plane is not None else float(depth.max())
    depth = (depth - near_plane) / (far_plane - near_plane + 1e-10)
    depth = np.clip(depth, 0.0, 1.0)
    img = apply_float_colormap(depth, colormap="turbo")
    if acc is not None:
        acc = np.asarray(acc, np.float32)
        img = img * acc + (1.0 - acc)
    return img


def save_image(image: np.ndarray, filename: str) -> None:
    """Write a float image in [0, 1] as an 8-bit RGB PNG: [H, W, 3],
    [H, W, 1], [1, H, W, 3] or [1, 3, H, W]. Makes the directory."""
    image = np.asarray(image)
    if image.ndim == 4:
        image = image[0]
    if image.ndim == 3 and image.shape[0] in (1, 3) and image.shape[-1] not in (1, 3):
        image = np.transpose(image, (1, 2, 0))
    if image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    d = os.path.dirname(filename)
    if d:
        os.makedirs(d, exist_ok=True)
    write_png(filename, (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8))
