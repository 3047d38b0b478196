"""World normalization: similarity transform from cameras + PCA alignment.

Pure-numpy port-equivalent of the reference's datasets/normalize.py
(similarity_from_cameras:4, align_principal_axes:66, transform_cameras:115,
transform_points:100) — standard scene-normalization math from the NeRF/3DGS
literature, re-derived here.

A numpy-only copy of ``tdgs/datasets/normalize.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def similarity_from_cameras(
    c2w: np.ndarray, strict_scaling: bool = False, center_method: str = "focus"
) -> np.ndarray:
    """Compute a 4x4 similarity that recenters/reorients/rescales the world
    from camera poses.

    - rotation: align the average camera "up" (-y of cam frames) with world +z
    - translation: either the focus point (closest point to all optical axes)
      or the mean camera position
    - scale: 1 / (max or median camera distance)
    """
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    # (1) rotate up to +z. Camera up in world = -R @ [0,1,0] (y-down convention)
    ups = -R[:, :3, 1]
    up = ups.mean(0)
    up = up / np.linalg.norm(up)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(up, z)
    s = np.linalg.norm(v)
    c = float(up @ z)
    if s < 1e-8:
        R_align = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R_align = np.eye(3) + vx + vx @ vx * ((1 - c) / s**2)

    R2 = R_align @ R
    t2 = (R_align @ t[..., None])[..., 0]

    # (2) translate
    if center_method == "focus":
        # closest point to all camera optical axes (least squares)
        dirs = R2[:, :3, 2]  # +z forward
        eye = np.eye(3)
        A = np.zeros((3, 3))
        b = np.zeros(3)
        for d, o in zip(dirs, t2):
            P = eye - np.outer(d, d)
            A += P
            b += P @ o
        try:
            center = np.linalg.solve(A, b)
        except np.linalg.LinAlgError:
            center = t2.mean(0)
    elif center_method == "poses":
        center = t2.mean(0)
    else:
        raise ValueError(center_method)

    # (3) scale
    dists = np.linalg.norm(t2 - center, axis=-1)
    scale = 1.0 / (np.max(dists) if strict_scaling else np.median(dists) + 1e-8)

    T = np.eye(4)
    T[:3, :3] = R_align * scale
    T[:3, 3] = -scale * (R_align @ center)
    return T


def align_principal_axes(points: np.ndarray) -> np.ndarray:
    """Rotation aligning the point cloud's principal axes to the world axes
    (smallest variance → z). Returns a 4x4 transform."""
    center = np.median(points, axis=0)
    centered = points - center
    cov = centered.T @ centered / len(points)
    eigval, eigvec = np.linalg.eigh(cov)
    # eigh: ascending eigvals; want largest variance on x, smallest on z
    R = eigvec[:, ::-1].T  # rows = principal dirs, descending variance
    if np.linalg.det(R) < 0:
        R[2] *= -1
    # keep +z pointing "up" toward the dominant original +z
    if R[2, 2] < 0:
        R[1] *= -1
        R[2] *= -1
        if np.linalg.det(R) < 0:
            R[0] *= -1
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ center
    return T


def transform_points(T: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ T[:3, :3].T + T[:3, 3]


def transform_cameras(T: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """Apply T to camera-to-world matrices, renormalizing rotation scale."""
    out = T @ c2w
    scale = np.linalg.norm(out[:, :3, 0], axis=-1)[:, None, None]
    out[:, :3, :3] = out[:, :3, :3] / scale
    return out
