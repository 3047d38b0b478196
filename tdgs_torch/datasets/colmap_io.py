"""Minimal COLMAP binary/text model reader (pure numpy, no pycolmap).

Implements the documented COLMAP sparse-model format
(https://colmap.github.io/format.html) — cameras/images/points3D in .bin or
.txt. Replaces the reference's pycolmap.SceneManager dependency
(reference: examples/datasets/colmap.py:56-120).

A numpy-only copy of ``tdgs/datasets/colmap_io.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {v[0]: k for k, v in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    def K(self) -> np.ndarray:
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)

    def distortion(self) -> Tuple[np.ndarray, str]:
        """Returns (dist params padded to OpenCV layout [k1,k2,p1,p2,k3,k4],
        type in {"perspective", "fisheye"})."""
        p = self.params
        d = np.zeros(6)
        if self.model == "SIMPLE_RADIAL":
            d[0] = p[3]
        elif self.model == "RADIAL":
            d[0], d[1] = p[3], p[4]
        elif self.model == "OPENCV":
            d[:4] = p[4:8]
        elif self.model == "FULL_OPENCV":
            d[0], d[1], d[2], d[3], d[4], d[5] = (
                p[4], p[5], p[6], p[7], p[8], p[9]
            )
        elif self.model == "OPENCV_FISHEYE":
            d[0], d[1], d[4], d[5] = p[4], p[5], p[6], p[7]
            return d, "fisheye"
        elif self.model in ("SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            d[0] = p[3]
            if self.model == "RADIAL_FISHEYE":
                d[1] = p[4]
            return d, "fisheye"
        return d, "perspective"


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # wxyz
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray  # [M, 2]
    point3D_ids: np.ndarray  # [M] int64, -1 = unmatched


@dataclass
class ColmapModel:
    cameras: Dict[int, ColmapCamera]
    images: Dict[int, ColmapImage]
    points: np.ndarray  # [P, 3]
    point_colors: np.ndarray  # [P, 3] uint8
    point_errors: np.ndarray  # [P]
    point_ids: np.ndarray  # [P] int64 (original ids, sorted order)


def _read(fd, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fd.read(size))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as fd:
        (n,) = _read(fd, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(fd, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(fd, f"<{np_}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as fd:
        (n,) = _read(fd, "<Q")
        for _ in range(n):
            (img_id,) = _read(fd, "<i")
            qvec = np.array(_read(fd, "<4d"))
            tvec = np.array(_read(fd, "<3d"))
            (cam_id,) = _read(fd, "<i")
            name = b""
            while True:
                c = fd.read(1)
                if c == b"\x00":
                    break
                name += c
            (m,) = _read(fd, "<Q")
            data = np.frombuffer(fd.read(24 * m), dtype=np.uint8).reshape(m, 24)
            xys = data[:, :16].copy().view(np.float64).reshape(m, 2)
            p3d = data[:, 16:].copy().view(np.int64).reshape(m)
            out[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode("utf-8"), xys, p3d
            )
    return out


def read_points3d_bin(path: str):
    with open(path, "rb") as fd:
        (n,) = _read(fd, "<Q")
        ids = np.empty(n, np.int64)
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n, np.float64)
        for i in range(n):
            (pid,) = _read(fd, "<q")
            xyz[i] = _read(fd, "<3d")
            rgb[i] = _read(fd, "<3B")
            (err[i],) = _read(fd, "<d")
            (track_len,) = _read(fd, "<Q")
            fd.seek(8 * track_len, os.SEEK_CUR)
            ids[i] = pid
    order = np.argsort(ids)
    return ids[order], xyz[order], rgb[order], err[order]


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as fd:
        for line in fd:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(x) for x in parts[4:]])
            out[cam_id] = ColmapCamera(cam_id, model, w, h, params)
    return out


def read_images_txt(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as fd:
        lines = [l.strip() for l in fd if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        m = len(pts) // 3
        xys = np.array([[float(pts[3 * j]), float(pts[3 * j + 1])] for j in range(m)])
        p3d = np.array([int(pts[3 * j + 2]) for j in range(m)], np.int64)
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name,
                                  xys.reshape(m, 2), p3d)
    return out


def read_points3d_txt(path: str):
    ids, xyz, rgb, err = [], [], [], []
    with open(path) as fd:
        for line in fd:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ids.append(int(parts[0]))
            xyz.append([float(x) for x in parts[1:4]])
            rgb.append([int(x) for x in parts[4:7]])
            err.append(float(parts[7]))
    ids = np.array(ids, np.int64)
    order = np.argsort(ids)
    return (
        ids[order],
        np.array(xyz)[order],
        np.array(rgb, np.uint8)[order],
        np.array(err)[order],
    )


def load_colmap_model(sparse_dir: str) -> ColmapModel:
    """Load a COLMAP sparse model dir (bin preferred, txt fallback)."""
    def pick(base):
        b = os.path.join(sparse_dir, base + ".bin")
        t = os.path.join(sparse_dir, base + ".txt")
        if os.path.exists(b):
            return b, True
        if os.path.exists(t):
            return t, False
        raise FileNotFoundError(f"missing {base}.bin/.txt in {sparse_dir}")

    cpath, cbin = pick("cameras")
    ipath, ibin = pick("images")
    ppath, pbin = pick("points3D")
    cameras = read_cameras_bin(cpath) if cbin else read_cameras_txt(cpath)
    images = read_images_bin(ipath) if ibin else read_images_txt(ipath)
    ids, xyz, rgb, err = (
        read_points3d_bin(ppath) if pbin else read_points3d_txt(ppath)
    )
    return ColmapModel(cameras, images, xyz, rgb, err, ids)


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> rotation matrix (numpy, for the host-side parser)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
