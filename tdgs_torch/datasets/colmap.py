"""COLMAP scene parser and dataset, host-side numpy (port of
``tdgs/datasets/colmap.py``).

The same parsing, splits, factor-downsampled image directories, numpy
undistortion maps, world normalization and scene scale as the JAX package.
Images are decoded by ``tdgs_torch.utils.png.imread`` (PIL when installed,
else a standard-library PNG decoder), on demand or ahead of use by the
thread-pool ``Prefetcher`` (``Dataset.enable_prefetch``). The fork
extensions of the JAX package come along: instance masks
(``masks/instance_ids_npy/{stem}_instance_id.npy``), monocular normal maps
(``normals/{stem}.npy`` or an RGB-encoded image), the sparse depths of the
SfM points each image tracks, and refined dense depths
(``refined_depths/{stem}_refined_depth.npy``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from tdgs_torch.datasets import normalize as nrm
from tdgs_torch.datasets.colmap_io import load_colmap_model, qvec_to_rotmat
from tdgs_torch.datasets.prefetch import Prefetcher
from tdgs_torch.utils.png import imread


def _nearest_resize(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbour resize of a [H, W(, C)] map to (height, width), to
    match auxiliary maps to the (possibly downsampled) images."""
    if arr.shape[:2] == (height, width):
        return arr
    yi = (np.arange(height) * arr.shape[0] / height).astype(np.int64)
    xi = (np.arange(width) * arr.shape[1] / width).astype(np.int64)
    return arr[yi][:, xi]


def _bilinear_remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """Sample img at float coords (map_x, map_y) with bilinear interpolation."""
    H, W = img.shape[:2]
    x0 = np.clip(np.floor(map_x).astype(np.int32), 0, W - 1)
    y0 = np.clip(np.floor(map_y).astype(np.int32), 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    wx = np.clip(map_x - x0, 0, 1)[..., None]
    wy = np.clip(map_y - y0, 0, 1)[..., None]
    img = img.astype(np.float32)
    top = img[y0, x0] * (1 - wx) + img[y0, x1] * wx
    bot = img[y1, x0] * (1 - wx) + img[y1, x1] * wx
    return top * (1 - wy) + bot * wy


def _distort_perspective(x, y, d):
    """OpenCV perspective distortion forward model (k1,k2,p1,p2,k3)."""
    k1, k2, p1, p2, k3, _ = d
    r2 = x * x + y * y
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _distort_fisheye(x, y, d):
    """OpenCV fisheye (equidistant) distortion forward model (k1..k4)."""
    k1, k2, _, _, k3, k4 = d
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    theta_d = theta * (
        1 + theta**2 * (k1 + theta**2 * (k2 + theta**2 * (k3 + theta**2 * k4)))
    )
    scale = np.where(r > 1e-8, theta_d / np.maximum(r, 1e-8), 1.0)
    return x * scale, y * scale


def build_undistort_map(K, dist, dist_type, width, height):
    """For each output (undistorted) pixel, the source pixel to sample
    (cv2.initUndistortRectifyMap with new K = K)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    x = (u - cx) / fx
    y = (v - cy) / fy
    if dist_type == "fisheye":
        xd, yd = _distort_fisheye(x, y, dist)
    else:
        xd, yd = _distort_perspective(x, y, dist)
    return (xd * fx + cx).astype(np.float32), (yd * fy + cy).astype(np.float32)


class Parser:
    """COLMAP scene parser."""

    def __init__(
        self,
        data_dir: str,
        factor: int = 1,
        normalize: bool = True,
        test_every: int = 8,
        load_instance_masks: bool = False,
        load_normals: bool = False,
    ):
        self.data_dir = data_dir
        self.factor = factor
        self.normalize = normalize
        self.test_every = test_every
        self.load_instance_masks = load_instance_masks
        self.load_normals = load_normals

        sparse = os.path.join(data_dir, "sparse", "0")
        if not os.path.isdir(sparse):
            sparse = os.path.join(data_dir, "sparse")
        model = load_colmap_model(sparse)

        # sorted by image name for deterministic splits
        images = sorted(model.images.values(), key=lambda im: im.name)
        self.image_names: List[str] = [im.name for im in images]
        w2c = np.stack([
            np.vstack([np.hstack([qvec_to_rotmat(im.qvec), im.tvec[:, None]]),
                       [0, 0, 0, 1]])
            for im in images
        ])
        camtoworlds = np.linalg.inv(w2c)

        # per-camera intrinsics, downscaled by factor
        self.Ks_dict: Dict[int, np.ndarray] = {}
        self.params_dict: Dict[int, Any] = {}
        self.imsize_dict: Dict[int, tuple] = {}
        self.camera_ids = [im.camera_id for im in images]
        self.mask_dict: Dict[int, Optional[np.ndarray]] = {}
        for cam_id, cam in model.cameras.items():
            K = cam.K().copy()
            K[:2] /= factor
            self.Ks_dict[cam_id] = K
            self.params_dict[cam_id] = cam.distortion()
            self.imsize_dict[cam_id] = (int(round(cam.width / factor)),
                                        int(round(cam.height / factor)))
            self.mask_dict[cam_id] = None

        img_dir = os.path.join(data_dir, f"images_{factor}" if factor > 1 else "images")
        if not os.path.isdir(img_dir):
            img_dir = os.path.join(data_dir, "images")
        self.image_dir = img_dir
        self.image_paths = [os.path.join(img_dir, name) for name in self.image_names]

        points = model.points.astype(np.float32)
        self.points_err = model.point_errors.astype(np.float32)
        self.points_rgb = model.point_colors

        # each image's tracked SfM points, as rows of ``points`` (the ids
        # are sorted; a track naming no point is dropped)
        self.point_indices: Dict[str, np.ndarray] = {}
        for im in images:
            pids = im.point3D_ids[im.point3D_ids >= 0]
            rows = np.searchsorted(model.point_ids, pids)
            found = rows < len(model.point_ids)
            found[found] = model.point_ids[rows[found]] == pids[found]
            self.point_indices[im.name] = rows[found].astype(np.int64)

        if normalize:
            T1 = nrm.similarity_from_cameras(camtoworlds)
            camtoworlds = nrm.transform_cameras(T1, camtoworlds)
            points = nrm.transform_points(T1, points)
            T2 = nrm.align_principal_axes(points)
            camtoworlds = nrm.transform_cameras(T2, camtoworlds)
            points = nrm.transform_points(T2, points)
            self.transform = T2 @ T1
        else:
            self.transform = np.eye(4)

        self.camtoworlds = camtoworlds.astype(np.float32)
        self.points = points.astype(np.float32)

        # scene scale from the camera spread
        camera_locs = camtoworlds[:, :3, 3]
        dists = np.linalg.norm(camera_locs - camera_locs.mean(0), axis=-1)
        self.scene_scale = float(dists.max()) * 1.1

    def undistort(self, cam_id: int, image: np.ndarray) -> np.ndarray:
        dist, dist_type = self.params_dict[cam_id]
        if not np.any(dist):
            return image
        H, W = image.shape[:2]
        mx, my = build_undistort_map(self.Ks_dict[cam_id], dist, dist_type, W, H)
        if self.mask_dict.get(cam_id) is None:
            # valid-pixel ROI: output pixels whose source lies in the frame
            self.mask_dict[cam_id] = (mx >= 0) & (mx <= W - 1) & (my >= 0) & (my <= H - 1)
        return _bilinear_remap(image, mx, my)


class Dataset:
    """Indexable dataset over a Parser split."""

    def __init__(self, parser: Parser, split: str = "train",
                 patch_size: Optional[int] = None, load_depths: bool = False):
        self.parser = parser
        self.split = split
        self.patch_size = patch_size
        self.load_depths = load_depths
        self._prefetcher: Optional[Prefetcher] = None
        idx = np.arange(len(parser.image_names))
        if split == "train":
            self.indices = idx[idx % parser.test_every != 0]
        else:
            self.indices = idx[idx % parser.test_every == 0]

    def __len__(self):
        return len(self.indices)

    def enable_prefetch(self, n_threads: int = 4) -> bool:
        """Start decoding ahead on ``n_threads`` threads (``prefetch`` queues
        the images, ``__getitem__`` takes them)."""
        if self._prefetcher is None:
            self._prefetcher = Prefetcher(self.parser.image_paths, factor=1,
                                          n_threads=n_threads)
        return True

    def prefetch(self, items) -> None:
        """Queue the decode of upcoming dataset items (returns at once)."""
        if self._prefetcher is None:
            return
        for it in np.asarray(items).reshape(-1):
            self._prefetcher.request(int(self.indices[int(it)]))

    def close(self) -> None:
        """Stop the decode-ahead threads, if any."""
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    def __getitem__(self, item: int) -> Dict[str, Any]:
        p = self.parser
        index = int(self.indices[item])
        cam_id = p.camera_ids[index]
        if self._prefetcher is not None:
            image = self._prefetcher.get(index)
        else:
            image = imread(p.image_paths[index])
        image = image.astype(np.float32) / 255.0
        image = p.undistort(cam_id, image)
        K = p.Ks_dict[cam_id].astype(np.float32)
        camtoworld = p.camtoworlds[index]
        data = {
            "K": K,
            "camtoworld": camtoworld,
            "viewmat": np.linalg.inv(camtoworld).astype(np.float32),
            "image": image,
            "image_id": index,
            "image_name": p.image_names[index],
        }
        if p.mask_dict.get(cam_id) is not None:
            # undistortion ROI: rendered pixels outside it are zeroed
            data["mask"] = p.mask_dict[cam_id]
        H, W = image.shape[:2]
        stem = os.path.splitext(p.image_names[index])[0]
        if p.load_normals:
            # normals/{stem}.npy ([-1, 1] float [H, W, 3]), else an RGB
            # encoding at normals/{image name}
            npy = os.path.join(p.data_dir, "normals", f"{stem}.npy")
            img = os.path.join(p.data_dir, "normals", p.image_names[index])
            nmap = None
            if os.path.exists(npy):
                nmap = np.load(npy).astype(np.float32)
            elif os.path.exists(img):
                nmap = imread(img).astype(np.float32) / 255.0 * 2.0 - 1.0
            if nmap is not None:
                data["normal"] = _nearest_resize(nmap, H, W)
        if self.load_depths:
            # the tracked SfM points in front of the camera and inside the image
            rows = p.point_indices.get(p.image_names[index], np.empty(0, np.int64))
            w2c = data["viewmat"]
            cam_pts = p.points[rows] @ w2c[:3, :3].T + w2c[:3, 3]
            depths = cam_pts[:, 2]
            uv = cam_pts @ K.T
            uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-8)
            sel = ((depths > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                   & (uv[:, 1] >= 0) & (uv[:, 1] < H))
            data["points"] = uv[sel].astype(np.float32)
            data["depths"] = depths[sel].astype(np.float32)
        if p.load_instance_masks:
            mpath = os.path.join(p.data_dir, "masks", "instance_ids_npy",
                                 f"{stem}_instance_id.npy")
            if os.path.exists(mpath):
                data["instance_mask"] = np.load(mpath)
        if p.load_instance_masks or self.load_depths:
            dpath = os.path.join(p.data_dir, "refined_depths", f"{stem}_refined_depth.npy")
            if os.path.exists(dpath):
                data["refined_depth"] = _nearest_resize(
                    np.load(dpath).astype(np.float32), H, W)
        if self.patch_size is not None:
            ps = self.patch_size
            x = np.random.randint(0, max(W - ps, 1))
            y = np.random.randint(0, max(H - ps, 1))
            data["image"] = image[y:y + ps, x:x + ps]
            K = K.copy()
            K[0, 2] -= x
            K[1, 2] -= y
            data["K"] = K
            for key in ("instance_mask", "refined_depth", "mask"):
                if key in data:
                    data[key] = data[key][y:y + ps, x:x + ps]
        return data
