"""PNG-based splat compression (port of
``tdgs/compression/png_compression.py``).

The splats are cropped to a square count (the lowest-opacity ones go),
laid on a side×side grid in Morton order of their centres, and each
attribute gets a codec: means → log transform, 16 bits split into two 8-bit
PNGs (high and low bytes); scales, quats, opacities and sh0 → 8-bit
min-max-quantized PNGs; shN → a K-means codebook (``segmentation.
clustering.kmeans`` on the device, from ``np.random.default_rng(0)``'s
choice of initial centroids, 10 iterations) stored as uint16 labels and
float16 centroids; any other per-gaussian array (the appearance features
and colours) → npz. ``meta.json`` holds the side and each attribute's
range. PNGs are written by PIL where it is installed (``optimize=True``, as
the JAX package writes them), else by ``utils.png``; either reader decodes
either writer's files.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np

from tdgs_torch._device import DeviceLike
from tdgs_torch.utils.ply import morton_sort_centers

_MAIN = ("means", "scales", "quats", "opacities", "sh0", "shN")


def _png_write(path: str, arr: np.ndarray) -> None:
    if arr.dtype != np.uint8:
        raise TypeError(f"{path}: uint8 expected, got {arr.dtype}")
    try:
        from PIL import Image
    except ImportError:
        from tdgs_torch.utils.png import write_png

        write_png(path, arr)
        return
    Image.fromarray(arr).save(path, optimize=True)


def _png_read(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        from tdgs_torch.utils.png import read_png

        return read_png(path)
    with Image.open(path) as im:
        return np.asarray(im)


def _quantize(x: np.ndarray, bits: int = 8):
    mins = x.min(axis=0)
    maxs = x.max(axis=0)
    span = np.maximum(maxs - mins, 1e-12)
    q = np.round((x - mins) / span * (2 ** bits - 1)).astype(
        np.uint8 if bits == 8 else np.uint16)
    return q, mins, maxs


def _dequantize(q: np.ndarray, mins, maxs, bits: int = 8) -> np.ndarray:
    span = np.asarray(maxs) - np.asarray(mins)
    return q.astype(np.float32) / (2 ** bits - 1) * span + np.asarray(mins)


def _log_transform(x):
    return np.sign(x) * np.log1p(np.abs(x))


def _inv_log_transform(y):
    return np.sign(y) * np.expm1(np.abs(y))


@dataclass
class PngCompression:
    """``compress`` a splats dict of numpy arrays to a directory of PNGs and
    ``decompress`` it back. ``device`` is where the shN K-means runs
    (default the card)."""

    n_clusters: int = 4096  # shN codebook size
    device: DeviceLike = None

    def compress(self, compress_dir: str, splats: Dict[str, np.ndarray]) -> None:
        os.makedirs(compress_dir, exist_ok=True)
        splats = {k: np.asarray(v) for k, v in splats.items()}
        n = splats["means"].shape[0]
        side = int(math.floor(math.sqrt(n)))
        n_crop = side * side
        if n_crop < n:
            keep = np.argsort(splats["opacities"].reshape(n))[n - n_crop:]
            splats = {k: v[keep] for k, v in splats.items()}
        order = morton_sort_centers(splats["means"])
        splats = {k: v[order] for k, v in splats.items()}
        meta: Dict = {"side": side, "attrs": {}}

        def grid(x):
            return x.reshape(side, side, *x.shape[1:])

        q, mins, maxs = _quantize(_log_transform(splats["means"]), bits=16)
        _png_write(os.path.join(compress_dir, "means_u.png"), grid((q >> 8).astype(np.uint8)))
        _png_write(os.path.join(compress_dir, "means_l.png"), grid((q & 0xFF).astype(np.uint8)))
        meta["attrs"]["means"] = {"mins": mins.tolist(), "maxs": maxs.tolist(), "log": True}

        for name, arr in (("scales", splats["scales"]), ("quats", splats["quats"]),
                          ("opacities", splats["opacities"].reshape(-1, 1)),
                          ("sh0", splats["sh0"].reshape(-1, 3))):
            q, mins, maxs = _quantize(arr, bits=8)
            _png_write(os.path.join(compress_dir, f"{name}.png"),
                       grid(q[:, 0] if name == "opacities" else q))
            meta["attrs"][name] = {"mins": np.atleast_1d(mins).tolist(),
                                   "maxs": np.atleast_1d(maxs).tolist()}

        shN = splats["shN"].reshape(n_crop, -1)
        if shN.shape[1] > 0:
            labels, cents = self._codebook(shN)
            np.savez_compressed(os.path.join(compress_dir, "shN.npz"),
                                labels=labels.astype(np.uint16),
                                centroids=cents.astype(np.float16),
                                shape=np.array(splats["shN"].shape))

        extras = {k: v for k, v in splats.items() if k not in _MAIN}
        if extras:
            np.savez_compressed(os.path.join(compress_dir, "extras.npz"), **extras)
        with open(os.path.join(compress_dir, "meta.json"), "w") as f:
            json.dump(meta, f)

    def _codebook(self, shN: np.ndarray):
        """(labels [n], centroids [k, F]) of the shN rows: K-means from
        ``np.random.default_rng(0)``'s choice of k rows."""
        from tdgs_torch.segmentation.clustering import kmeans

        n = shN.shape[0]
        k = min(self.n_clusters, n)
        init = shN[np.random.default_rng(0).choice(n, k, replace=False)]
        labels, cents = kmeans(shN, init, iters=10, device=self.device)
        return labels.cpu().numpy(), cents.cpu().numpy()

    def decompress(self, compress_dir: str) -> Dict[str, np.ndarray]:
        with open(os.path.join(compress_dir, "meta.json")) as f:
            meta = json.load(f)
        side = meta["side"]
        n = side * side

        hi = _png_read(os.path.join(compress_dir, "means_u.png")).reshape(n, 3)
        lo = _png_read(os.path.join(compress_dir, "means_l.png")).reshape(n, 3)
        q16 = (hi.astype(np.uint16) << 8) | lo.astype(np.uint16)
        a = meta["attrs"]["means"]
        means = _inv_log_transform(_dequantize(q16, a["mins"], a["maxs"], bits=16))
        out = {"means": means.astype(np.float32)}
        for name, ch in (("scales", 3), ("quats", 4), ("opacities", 1), ("sh0", 3)):
            q = _png_read(os.path.join(compress_dir, f"{name}.png")).reshape(n, ch)
            a = meta["attrs"][name]
            x = _dequantize(q, a["mins"], a["maxs"], bits=8).astype(np.float32)
            if name == "opacities":
                x = x[:, 0]
            elif name == "sh0":
                x = x.reshape(n, 1, 3)
            out[name] = x

        shn_path = os.path.join(compress_dir, "shN.npz")
        if os.path.exists(shn_path):
            with np.load(shn_path) as z:
                cents = z["centroids"].astype(np.float32)
                labels = z["labels"].astype(np.int64)
                shape = z["shape"]
            out["shN"] = cents[labels].reshape(tuple(shape))
        else:
            out["shN"] = np.zeros((n, 0, 3), np.float32)

        extras_path = os.path.join(compress_dir, "extras.npz")
        if os.path.exists(extras_path):
            with np.load(extras_path) as z:
                for k in z.files:
                    out[k] = z[k]
        return out
