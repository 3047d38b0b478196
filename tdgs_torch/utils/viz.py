"""Colour maps, image saving and disparity dumps (numpy port of
``tdgs/utils/viz.py``), plus ``set_random_seed``.

Neither matplotlib nor PIL is needed but by ``colormap`` (a matplotlib
figure with a colour bar, imported when called): the ``turbo`` and
``viridis`` tables are constants (``_turbo.py``, ``_viridis.py``) and
images go through ``utils/png.write_png``.
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch

from tdgs_torch.utils._turbo import TURBO
from tdgs_torch.utils._viridis import VIRIDIS
from tdgs_torch.utils.png import write_png

_TABLES = {"turbo": TURBO, "viridis": VIRIDIS}


def set_random_seed(seed: int) -> torch.Generator:
    """Seed Python's and numpy's global generators and return a CPU
    ``torch.Generator`` seeded with ``seed``, the port's counterpart of the
    JAX package's returned key: draws take it explicitly."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def apply_float_colormap(img: np.ndarray, colormap: str = "turbo") -> np.ndarray:
    """[..., 1] float in [0, 1] → [..., 3] float colours in [0, 1]; NaN
    reads as 0. ``colormap`` is "turbo", "viridis" or "gray"."""
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


def colormap(img: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """A 2D array drawn through a matplotlib colour map with a colour bar,
    as an RGB uint8 canvas [H', W', 3] (the reference's utils.py:163-177,
    HWC uint8 in place of a CHW tensor). Needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    W, H = img.shape[:2]
    dpi = 300
    fig, ax = plt.subplots(1, figsize=(H / dpi, W / dpi), dpi=dpi)
    im = ax.imshow(img, cmap=cmap)
    ax.set_axis_off()
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return data


# the reference's names for the numpy and tensor forms of the same saver
save_image_numpy = save_image
save_image_tensor = save_image


def save_disparity_image(
    disp: np.ndarray,
    output_path: str,
    points: Optional[np.ndarray] = None,
    height: Optional[int] = None,
    width: Optional[int] = None,
    cmap: Optional[str] = "viridis",
) -> None:
    """Save a dense [H, W] or sparse [M] disparity map scaled to its min and
    max through ``cmap`` (None: grey). Sparse values land on a black canvas
    at the integer ``points`` [M, 2] (x, y)."""
    disp = np.asarray(disp, np.float32).squeeze()
    if disp.ndim == 1:
        if points is None or not height or not width:
            raise ValueError("a sparse disparity needs points, height and width")
        canvas = np.zeros((height, width), np.float32)
        pts = np.asarray(points).reshape(-1, 2).astype(np.int64)
        xs = np.clip(pts[:, 0], 0, width - 1)
        ys = np.clip(pts[:, 1], 0, height - 1)
        canvas[ys, xs] = disp
        disp = canvas
    lo, hi = float(disp.min()), float(disp.max())
    norm = (disp - lo) / (hi - lo + 1e-10)
    if cmap is None:
        img = np.repeat(norm[..., None], 3, axis=-1)
    else:
        img = apply_float_colormap(norm[..., None], colormap=cmap)
    save_image(img, output_path)
