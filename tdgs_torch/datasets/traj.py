"""Camera trajectories for the trajectory render (numpy copy of
``tdgs/datasets/traj.py``): ``generate_interpolated_path`` (a Catmull-Rom
spline through keyframe poses), ``generate_ellipse_path_z`` and
``generate_spiral_path``. Poses are [N, 3, 4] camera-to-world.
"""

from __future__ import annotations

import numpy as np


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-12)


def viewmatrix(lookdir: np.ndarray, up: np.ndarray, position: np.ndarray) -> np.ndarray:
    """Camera-to-world from forward dir, up hint, and position (OpenCV
    convention: +z forward, +y down)."""
    z = _normalize(lookdir)
    x = _normalize(np.cross(_normalize(up), z))
    y = np.cross(z, x)
    return np.stack([x, y, z, position], axis=1)  # [3, 4]


def poses_to_points(poses: np.ndarray, dist: float) -> np.ndarray:
    """Represent each pose by (position, forward-point, up-point)."""
    pos = poses[:, :3, 3]
    fwd = pos + dist * poses[:, :3, 2]
    up = pos - dist * poses[:, :3, 1]
    return np.stack([pos, fwd, up], axis=1)  # [N, 3, 3]


def points_to_poses(points: np.ndarray) -> np.ndarray:
    return np.stack(
        [
            viewmatrix(f - p, p - u, p)
            for p, f, u in zip(points[:, 0], points[:, 1], points[:, 2])
        ]
    )


def _catmull_rom(points: np.ndarray, n_out: int) -> np.ndarray:
    """Centripetal-ish Catmull-Rom spline through control points [N, D]."""
    N = len(points)
    if N < 2:
        return np.repeat(points, n_out, axis=0)
    pts = np.concatenate([points[:1], points, points[-1:]], axis=0)  # pad ends
    t = np.linspace(0, N - 1, n_out, endpoint=False)
    idx = np.clip(t.astype(int), 0, N - 2)
    u = (t - idx)[:, None]
    p0 = pts[idx]
    p1 = pts[idx + 1]
    p2 = pts[idx + 2]
    p3 = pts[idx + 3]
    return 0.5 * (
        (2 * p1)
        + (-p0 + p2) * u
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * u**2
        + (-p0 + 3 * p1 - 3 * p2 + p3) * u**3
    )


def generate_interpolated_path(
    poses: np.ndarray,  # [N, 3, 4] c2w
    n_interp: int,
    spline_degree: int = 5,
    smoothness: float = 0.03,
    rot_weight: float = 0.1,
) -> np.ndarray:
    """Smooth path through keyframe poses (reference traj.py:206). The
    scipy B-spline is replaced by a Catmull-Rom spline over the
    (position, lookat, up) point representation."""
    del spline_degree, smoothness
    points = poses_to_points(poses, dist=rot_weight)  # [N, 3, 3]
    flat = points.reshape(len(poses), 9)
    new_flat = _catmull_rom(flat, n_interp * (len(poses) - 1))
    return points_to_poses(new_flat.reshape(-1, 3, 3))


def generate_ellipse_path_z(
    poses: np.ndarray,  # [N, 3, 4]
    n_frames: int = 120,
    variation: float = 0.0,
    phase: float = 0.0,
    height: float | None = None,
) -> np.ndarray:
    """Elliptical orbit in the xy-plane around the scene focus
    (reference traj.py:82)."""
    center = poses[:, :3, 3].mean(0)
    offsets = poses[:, :3, 3] - center
    # 90th-percentile extent like typical implementations
    sc = np.percentile(np.abs(offsets), 90, axis=0)
    if height is None:
        height = center[2]
    theta = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    z_var = variation * np.sin(theta * 2 + phase * 2 * np.pi)
    positions = np.stack(
        [
            center[0] + sc[0] * np.cos(theta),
            center[1] + sc[1] * np.sin(theta),
            np.full_like(theta, height) + z_var * sc[2],
        ],
        axis=-1,
    )
    up = np.array([0.0, 0.0, 1.0])
    avg_up = _normalize(-poses[:, :3, 1].mean(0))
    if avg_up @ up < 0:
        up = -up
    return np.stack([viewmatrix(center - p, up, p) for p in positions])


def generate_spiral_path(
    poses: np.ndarray,  # [N, 3, 4]
    bounds: np.ndarray | None = None,
    n_frames: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
    spiral_scale_f: float = 1.0,
    spiral_scale_r: float = 1.0,
    focus_distance: float = 0.75,
) -> np.ndarray:
    """Forward-facing spiral (LLFF convention; reference traj.py:43)."""
    pos = poses[:, :3, 3]
    c2w_avg_pos = pos.mean(0)
    fwd = _normalize(poses[:, :3, 2].mean(0))
    up = _normalize(-poses[:, :3, 1].mean(0))
    radii = np.percentile(np.abs(pos - c2w_avg_pos), 90, axis=0) * spiral_scale_r
    focal = focus_distance * spiral_scale_f

    out = []
    for theta in np.linspace(0, 2 * np.pi * n_rots, n_frames, endpoint=False):
        offset = (
            np.cos(theta) * radii[0] * _normalize(np.cross(up, fwd))
            + np.sin(theta) * radii[1] * up
            + np.sin(theta * zrate) * radii[2] * fwd
        )
        p = c2w_avg_pos + offset
        lookat = c2w_avg_pos + focal * fwd
        out.append(viewmatrix(lookat - p, up, p))
    return np.stack(out)
