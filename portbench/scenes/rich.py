"""The rich procedural scene, frozen: a textured multi-frequency terrain
with 28 boxes, ellipsoids and thin pillars, seen from three orbit rings of
cameras (a frozen copy of the scene of the system's ``make_rich_scene``,
seed 11, extent 4), laid out as a Mip-NeRF 360 capture at ``--data_factor
4``: a COLMAP model at the full resolution and the images, four times
smaller, under ``images_4``.

``Surfaces`` samples points on the same surfaces with the texture's
colours: the ground truth is 150k such gaussians, and the trained state
of a cell is drawn on them from the run's seed."""

from __future__ import annotations

import os
import struct
from typing import Dict

import numpy as np


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World-to-camera [4, 4] of an OpenCV camera at ``eye`` looking at
    ``target`` (z-up world; camera +z forward, +y down)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0], np.float32))
    right /= np.linalg.norm(right) + 1e-12
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd]).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = R
    vm[:3, 3] = -R @ eye
    return vm


def box_surface(rng, n, he):
    """n points uniform on the surface of an axis-aligned box of half
    extents ``he``."""
    hx, hy, hz = he
    areas = np.array([hy * hz, hy * hz, hx * hz, hx * hz, hx * hy, hx * hy])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = rng.uniform(-1, 1, size=(n, 2))
    pts = np.empty((n, 3), np.float32)
    for f in range(6):
        m = face == f
        axis = f // 2
        others = [a for a in range(3) if a != axis]
        p = np.zeros((m.sum(), 3), np.float32)
        p[:, axis] = (1.0 if f % 2 == 0 else -1.0) * he[axis]
        p[:, others[0]] = u[m, 0] * he[others[0]]
        p[:, others[1]] = u[m, 1] * he[others[1]]
        pts[m] = p
    return pts


def terrain_z(xy):
    x, y = xy[:, 0], xy[:, 1]
    return (0.35 * np.sin(1.1 * x) * np.cos(0.9 * y)
            + 0.18 * np.sin(2.6 * x + 1.3) * np.sin(2.1 * y)
            + 0.08 * np.sin(5.3 * x + 2.1 * y)).astype(np.float32)


def texture(p, rng):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    r = 0.5 + 0.25 * np.sin(3.1 * x) * np.cos(2.3 * y) + 0.15 * np.sin(9.7 * x + 5.1 * y)
    g = 0.5 + 0.25 * np.cos(2.7 * x + 1.1) * np.sin(3.7 * y) + 0.15 * np.sin(8.3 * y + 3.7 * z)
    b = 0.45 + 0.3 * np.sin(1.9 * x + 2.9 * y + 4.1 * z) + 0.1 * np.cos(11.3 * x)
    c = np.stack([r, g, b], -1) + rng.uniform(-0.04, 0.04, (len(p), 3))
    return np.clip(c, 0.02, 1.0).astype(np.float32)


class Surfaces:
    """The scene's surfaces: the ground (55% of the points) and 28 objects
    (boxes, ellipsoids, pillars), laid out by the scene's own seed."""

    def __init__(self, seed: int = 11, extent: float = 4.0):
        rng = np.random.default_rng(seed)
        self.S = extent
        self.objects = []
        for i in range(28):
            cx, cy = rng.uniform(-0.75 * extent, 0.75 * extent, 2)
            base = float(terrain_z(np.array([[cx, cy]], np.float32))[0])
            kind = i % 3
            if kind == 0:
                he = rng.uniform(0.15, 0.55, 3)
            elif kind == 1:
                he = rng.uniform(0.15, 0.5, 3)
            else:
                he = np.array([0.08, 0.08, rng.uniform(0.6, 1.2)])
            self.objects.append((kind, np.array([cx, cy, base]), he))

    def sample(self, n: int, rng) -> Dict[str, np.ndarray]:
        """n points with the texture's colours, 55% on the ground and the
        rest shared evenly by the objects; ``ground`` marks the first."""
        n_ground = int(n * 0.55)
        gxy = rng.uniform(-self.S, self.S, size=(n_ground, 2)).astype(np.float32)
        parts = [np.concatenate([gxy, terrain_z(gxy)[:, None]], 1)]
        per = (n - n_ground) // len(self.objects)
        for j, (kind, c, he) in enumerate(self.objects):
            m = per + (1 if j < (n - n_ground) - per * len(self.objects) else 0)
            if kind == 1:
                u = rng.normal(size=(m, 3))
                u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-9
                pts = (u * he).astype(np.float32)
            else:
                pts = box_surface(rng, m, he)
            pts[:, 2] += he[2]
            parts.append(pts + c.astype(np.float32))
        means = np.concatenate(parts).astype(np.float32)
        return {"means": means, "colors": texture(means, rng), "n_ground": n_ground}


def cameras(n_images: int, width: int, height: int):
    """Three orbit rings around the scene (elevations 18, 32, 50 degrees)
    → (viewmats [n, 4, 4], K [3, 3])."""
    S = 4.0
    center = np.array([0.0, 0.0, 0.25], np.float32)
    f = 0.82 * max(width, height)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    vms = []
    for i in range(n_images):
        az = 2 * np.pi * i / n_images * 3.0
        ring = i * 3 // n_images
        el = np.deg2rad((18.0, 32.0, 50.0)[ring])
        radius = (1.45, 1.25, 1.1)[ring] * S
        eye = center + radius * np.array(
            [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)], np.float32)
        vms.append(look_at(eye, center))
    return np.stack(vms), K


def ground_truth(surfaces: Surfaces, n_gt: int = 150_000, seed: int = 11):
    """The 150k ground-truth gaussians: isotropic, sized to the ground's
    spacing (objects' 0.56 of it), opacity 0.9."""
    rng = np.random.default_rng(seed + 1)
    pts = surfaces.sample(n_gt, rng)
    n = len(pts["means"])
    scale = np.full((n, 3), 2.2 * surfaces.S / np.sqrt(pts["n_ground"]), np.float32)
    scale[pts["n_ground"]:] *= 0.56
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    return {"means": pts["means"], "quats": quats, "scales": scale,
            "opacities": np.full((n,), 0.9, np.float32), "colors": pts["colors"]}


def _rotmat_to_qvec(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def write_colmap(sparse, width, height, f, viewmats, names, pts, cols):
    """cameras.bin, images.bin and points3D.bin of one shared PINHOLE
    camera (COLMAP's binary format); no image observes a point."""
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as fd:
        fd.write(struct.pack("<Q", 1))
        fd.write(struct.pack("<iiQQ", 1, 1, width, height))
        fd.write(struct.pack("<4d", f, f, width / 2, height / 2))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as fd:
        fd.write(struct.pack("<Q", len(pts)))
        rgb = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
        for i in range(len(pts)):
            fd.write(struct.pack("<q3d3BdQ", i + 1, *pts[i], *rgb[i], 0.5, 0))
    with open(os.path.join(sparse, "images.bin"), "wb") as fd:
        fd.write(struct.pack("<Q", len(viewmats)))
        for i, vm in enumerate(viewmats):
            fd.write(struct.pack("<i4d3di", i + 1, *_rotmat_to_qvec(vm[:3, :3]),
                                 *vm[:3, 3], 1))
            fd.write(names[i].encode() + b"\x00")
            fd.write(struct.pack("<Q", 0))
