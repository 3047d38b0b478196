"""Procedural scenes (numpy copies of ``tdgs/utils/test_data.py``).

Same seeds, same draws, same arrays as the JAX package:

- ``load_test_data`` (:22): the viewer's synthetic scene, a seeded blob
  cloud above z = 0, replicated over a ``scene_grid`` of cells with one
  camera each;
- ``make_domino_scene_arrays``: the ground-truth half of
  ``make_domino_scene`` (:152), a row of coloured dominoes (z-up, ground
  z = 0, the physics engine's frame) on a ground plane of flat disks, plus
  an orbit of look-at cameras;
- ``make_domino_scene`` (:152): that scene written as a COLMAP dataset with
  per-view instance-id masks (``masks/instance_ids_npy``), for training
  with segmentation;
- ``make_colmap_test_scene`` (:307) and ``make_rich_scene`` (:380): COLMAP
  scenes for training, whose ground-truth images are rendered here by the
  port's own ``packed_inference`` rasterizer and written as PNG with the
  standard library; the COLMAP files are written with ``struct``. With
  tracks (``make_colmap_test_scene(tracks=True)``, ``tracked_copy``) each
  image observes the SfM points it sees, for the sparse depth loss.
"""

from __future__ import annotations

import os
import struct
from typing import Dict

import numpy as np

from tdgs_torch._device import DeviceLike, as_float, resolve_device
from tdgs_torch.utils.png import write_png

# flat backdrop the domino GT images are composited onto
DOMINO_BACKGROUND = 0.78


def load_test_data(device=None, scene_grid: int = 1, n: int = 1000, seed: int = 42):
    """(means, quats, scales, opacities, colors, viewmats, Ks, width,
    height) as numpy arrays: ``n`` gaussians a grid cell (activated scales
    and opacities, RGB colours) and one 640x480 camera a cell, 6 units
    back and 1.5 up. ``device`` is accepted for the reference's signature
    and unused: the arrays stay on the host."""
    rng = np.random.default_rng(seed)
    base_means = rng.normal(size=(n, 3)).astype(np.float32) * [1.2, 1.2, 0.4]
    base_means[:, 2] += 0.5
    colors = rng.uniform(0.1, 1.0, size=(n, 3)).astype(np.float32)

    means_list, colors_list = [], []
    viewmats, Ks = [], []
    width, height = 640, 480
    f = 500.0
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    g = scene_grid
    for gy in range(g):
        for gx in range(g):
            offset = np.array([4.0 * gx, 4.0 * gy, 0.0], np.float32)
            means_list.append(base_means + offset)
            colors_list.append(colors)
            vm = np.eye(4, dtype=np.float32)
            vm[:3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
            cam = offset + np.array([0.0, -6.0, 1.5], np.float32)
            vm[:3, 3] = -(vm[:3, :3] @ cam)
            viewmats.append(vm)
            Ks.append(K)

    means = np.concatenate(means_list)
    colors_all = np.concatenate(colors_list)
    m = means.shape[0]
    quats = rng.normal(size=(m, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, size=(m, 3)).astype(np.float32)
    opacities = rng.uniform(0.4, 1.0, size=(m,)).astype(np.float32)
    return (means, quats, scales, opacities, colors_all, np.stack(viewmats), np.stack(Ks),
            width, height)


def _look_at_viewmat(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World-to-camera [4,4] for an OpenCV camera at eye looking at target
    (z-up world; camera +z forward, +y down)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right) + 1e-12
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd]).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = R
    vm[:3, 3] = -R @ eye
    return vm


def _sample_box_surface(rng, n, half_extents):
    """Uniform sample n points on the surface of an axis-aligned box."""
    hx, hy, hz = half_extents
    areas = np.array([hy * hz, hy * hz, hx * hz, hx * hz, hx * hy, hx * hy])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = rng.uniform(-1, 1, size=(n, 2))
    pts = np.empty((n, 3), np.float32)
    for f in range(6):
        m = face == f
        axis = f // 2
        sign = 1.0 if f % 2 == 0 else -1.0
        he = [hx, hy, hz]
        p = np.zeros((m.sum(), 3), np.float32)
        p[:, axis] = sign * he[axis]
        others = [a for a in range(3) if a != axis]
        p[:, others[0]] = u[m, 0] * he[others[0]]
        p[:, others[1]] = u[m, 1] * he[others[1]]
        pts[m] = p
    return pts


def make_domino_scene_arrays(
    n_dominoes: int = 6,
    n_images: int = 32,
    width: int = 480,
    height: int = 360,
    gauss_per_domino: int = 700,
    ground_gauss: int = 2500,
    seed: int = 3,
    domino_half_extents=(0.05, 0.2, 0.4),
    spacing: float = 0.55,
) -> Dict[str, np.ndarray]:
    """GT arrays of the domino scene: means/quats/scales/opacities/colors/
    labels (0 = ground, 1..n_dominoes), viewmats/Ks, half_extents,
    spacing."""
    return _domino_arrays(np.random.default_rng(seed), n_dominoes, n_images, width, height,
                          gauss_per_domino, ground_gauss, domino_half_extents, spacing)


def _domino_arrays(rng, n_dominoes, n_images, width, height, gauss_per_domino,
                   ground_gauss, domino_half_extents, spacing) -> Dict[str, np.ndarray]:
    hx, hy, hz = domino_half_extents

    means_list, cols_list, labels_list = [], [], []
    # ground plane: thin disks on z≈0, subdued checker tint
    span = spacing * n_dominoes * 0.75 + 1.0
    gxy = rng.uniform(-span, span, size=(ground_gauss, 2)).astype(np.float32)
    gxy[:, 0] += spacing * (n_dominoes - 1) / 2  # center under the row
    gz = np.zeros((ground_gauss, 1), np.float32)
    checker = ((np.floor(gxy[:, 0] * 2) + np.floor(gxy[:, 1] * 2)) % 2)
    gcol = np.stack([0.35 + 0.15 * checker] * 3, axis=-1).astype(np.float32)
    gcol += rng.uniform(-0.03, 0.03, size=gcol.shape).astype(np.float32)
    means_list.append(np.concatenate([gxy, gz], axis=1))
    cols_list.append(gcol)
    labels_list.append(np.zeros(ground_gauss, np.int32))

    # dominoes: a row along +x, thin along x so they topple forward
    hues = np.linspace(0.0, 1.0, n_dominoes, endpoint=False)
    for d in range(n_dominoes):
        pts = _sample_box_surface(rng, gauss_per_domino, (hx, hy, hz))
        pts[:, 0] += spacing * d
        pts[:, 2] += hz  # stand on the ground
        h = hues[d]
        base = np.array(
            [abs(h * 6 - 3) - 1, 2 - abs(h * 6 - 2), 2 - abs(h * 6 - 4)]
        ).clip(0, 1)
        col = np.tile(base[None].astype(np.float32), (gauss_per_domino, 1))
        col *= rng.uniform(0.75, 1.0, size=(gauss_per_domino, 1)).astype(np.float32)
        means_list.append(pts.astype(np.float32))
        cols_list.append(col)
        labels_list.append(np.full(gauss_per_domino, d + 1, np.int32))

    means = np.concatenate(means_list)
    cols = np.concatenate(cols_list)
    labels = np.concatenate(labels_list)
    n = means.shape[0]
    quats = np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32)
    scales = np.full((n, 3), 0.030, np.float32)
    scales[labels == 0] = [0.10, 0.10, 0.01]  # flat ground disks
    opac = np.full((n,), 0.92, np.float32)

    # orbit cameras around the row center, slightly elevated
    center = np.array([spacing * (n_dominoes - 1) / 2, 0.0, hz], np.float32)
    radius = max(2.2, spacing * n_dominoes * 0.9)
    f = 1.05 * max(width, height)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    viewmats = []
    for i in range(n_images):
        az = 2 * np.pi * i / n_images
        el = np.deg2rad(22.0 + 14.0 * ((i % 4) / 3.0))
        eye = center + radius * np.array(
            [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)],
            np.float32,
        )
        viewmats.append(_look_at_viewmat(eye, center))
    return {
        "means": means, "quats": quats, "scales": scales,
        "opacities": opac, "colors": cols, "labels": labels,
        "viewmats": np.stack(viewmats), "Ks": np.tile(K, (n_images, 1, 1)),
        "half_extents": np.array([hx, hy, hz], np.float32),
        "spacing": spacing,
    }


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → COLMAP wxyz quaternion (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return (q / np.linalg.norm(q)).astype(np.float64)


def visible_tracks(pts, viewmats, f, width, height):
    """Per image, the SfM rows that project inside it (in front of the
    camera, within the pixel bounds of the shared PINHOLE camera) and their
    pixel coordinates: a list of (rows [M] int64, xys [M, 2])."""
    out = []
    for vm in viewmats:
        cam = pts @ vm[:3, :3].T + vm[:3, 3]
        z = cam[:, 2]
        uv = f * cam[:, :2] / np.where(z > 0, z, 1.0)[:, None] + [width / 2, height / 2]
        sel = ((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < width)
               & (uv[:, 1] >= 0) & (uv[:, 1] < height))
        rows = np.nonzero(sel)[0]
        out.append((rows, uv[rows]))
    return out


def _write_colmap_sparse(sparse, width, height, f, viewmats, image_names, pts, cols,
                         tracks=None):
    """Minimal cameras.bin / images.bin / points3D.bin: one PINHOLE camera
    shared by all images, the orbit rotations as qvecs. ``tracks`` (per
    image, (rows, xys) as ``visible_tracks`` gives them) become each
    image's 2D points and each 3D point's track; without them no image
    observes any point."""
    os.makedirs(sparse, exist_ok=True)
    observed = [[] for _ in range(len(pts))]  # per point: (image id, 2D index)
    for i, (rows, _) in enumerate(tracks or ()):
        for j, r in enumerate(rows):
            observed[r].append((i + 1, j))
    with open(os.path.join(sparse, "cameras.bin"), "wb") as fd:
        fd.write(struct.pack("<Q", 1))
        fd.write(struct.pack("<iiQQ", 1, 1, width, height))
        fd.write(struct.pack("<4d", f, f, width / 2, height / 2))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as fd:
        fd.write(struct.pack("<Q", len(pts)))
        for i in range(len(pts)):
            fd.write(struct.pack("<q", i + 1))
            fd.write(struct.pack("<3d", *pts[i]))
            fd.write(struct.pack("<3B", *(np.clip(cols[i], 0, 1) * 255).astype(np.uint8)))
            fd.write(struct.pack("<d", 0.5))
            fd.write(struct.pack("<Q", len(observed[i])))
            for image_id, k in observed[i]:
                fd.write(struct.pack("<ii", image_id, k))
    with open(os.path.join(sparse, "images.bin"), "wb") as fd:
        fd.write(struct.pack("<Q", len(viewmats)))
        for i, vm in enumerate(viewmats):
            fd.write(struct.pack("<i", i + 1))
            fd.write(struct.pack("<4d", *_rotmat_to_qvec(vm[:3, :3])))
            fd.write(struct.pack("<3d", *vm[:3, 3]))
            fd.write(struct.pack("<i", 1))
            fd.write(image_names[i].encode() + b"\x00")
            if tracks is None:
                fd.write(struct.pack("<Q", 0))
                continue
            rows, xys = tracks[i]
            fd.write(struct.pack("<Q", len(rows)))
            for r, (x, y) in zip(rows, xys):
                fd.write(struct.pack("<ddq", x, y, int(r) + 1))


def tracked_copy(src_root, dst_root) -> None:
    """A copy of a scene these functions wrote (one PINHOLE camera) whose
    images track the SfM points they see (``visible_tracks``): the sparse
    model is written anew under ``dst_root``, the images directory is
    linked."""
    from tdgs_torch.datasets.colmap_io import load_colmap_model, qvec_to_rotmat

    model = load_colmap_model(os.path.join(src_root, "sparse", "0"))
    (cam,) = model.cameras.values()
    images = [model.images[k] for k in sorted(model.images)]
    viewmats = np.tile(np.eye(4), (len(images), 1, 1))
    for i, im in enumerate(images):
        viewmats[i, :3, :3] = qvec_to_rotmat(im.qvec)
        viewmats[i, :3, 3] = im.tvec
    tracks = visible_tracks(model.points, viewmats, cam.params[0], cam.width, cam.height)
    # colours round-trip: (c + 0.5) / 255 writes back as c
    cols = (model.point_colors.astype(np.float64) + 0.5) / 255.0
    _write_colmap_sparse(os.path.join(dst_root, "sparse", "0"), cam.width, cam.height,
                         cam.params[0], viewmats, [im.name for im in images],
                         model.points, cols, tracks=tracks)
    os.symlink(os.path.abspath(os.path.join(src_root, "images")),
               os.path.join(dst_root, "images"))


def _render_gt(means, quats, scales, opac, cols, viewmats, Ks, width, height,
               background, device, **kw) -> np.ndarray:
    """Ground-truth images [C, H, W, D] in [0, 1] (``cols`` [N, D]) by the
    port's forward-only packed rasterizer, one camera at a time;
    ``background`` None composites onto zeros."""
    from tdgs_torch.rendering import rasterization

    dev = resolve_device(device)
    t = {k: as_float(v, dev) for k, v in dict(
        means=means, quats=quats, scales=scales, opac=opac, cols=cols).items()}
    out = []
    for i in range(len(viewmats)):
        img, _, _ = rasterization(
            t["means"], t["quats"], t["scales"], t["opac"], t["cols"],
            viewmats[i:i + 1], Ks[i:i + 1], width, height,
            backgrounds=(None if background is None
                         else np.full((1, cols.shape[-1]), background, np.float32)),
            rasterizer="packed_inference", device=dev, **kw)
        out.append(np.clip(img[0].cpu().numpy(), 0, 1))
    return np.stack(out)


def make_domino_scene(
    root,
    n_dominoes: int = 6,
    n_images: int = 32,
    width: int = 480,
    height: int = 360,
    gauss_per_domino: int = 700,
    ground_gauss: int = 2500,
    seed: int = 3,
    domino_half_extents=(0.05, 0.2, 0.4),
    spacing: float = 0.55,
    sfm_points: int = 4000,
    device: DeviceLike = None,
):
    """Write the domino scene as a COLMAP dataset under ``root``: PNG
    images rendered on ``DOMINO_BACKGROUND``, ``sparse/0`` with
    ``sfm_points`` ground-truth gaussians as the triangulated points, and
    per view an instance-id mask (ids 1..n_dominoes, 0 = background)
    ``masks/instance_ids_npy/{stem}_instance_id.npy``: the argmax of a
    render of one-hot domino features where its maximum passes 0.35.
    Renders use exact tile coverage. Returns the ground-truth arrays with
    the images and masks."""
    rng = np.random.default_rng(seed)
    s = _domino_arrays(rng, n_dominoes, n_images, width, height, gauss_per_domino,
                       ground_gauss, domino_half_extents, spacing)
    means, quats, scales, opac = s["means"], s["quats"], s["scales"], s["opacities"]
    labels, viewmats, Ks = s["labels"], s["viewmats"], s["Ks"]
    n = means.shape[0]
    onehot = np.zeros((n, n_dominoes), np.float32)
    fg = labels > 0
    onehot[fg, labels[fg] - 1] = 1.0
    kw = dict(tile_capacity=512, isect_exact=True)
    imgs = _render_gt(means, quats, scales, opac, s["colors"], viewmats, Ks, width, height,
                      DOMINO_BACKGROUND, device, **kw)
    fmap = _render_gt(means, quats, scales, opac, onehot, viewmats, Ks, width, height,
                      None, device, **kw)
    masks = np.where(fmap.max(axis=-1) > 0.35, fmap.argmax(axis=-1) + 1, 0).astype(np.int32)

    names = [f"img_{i:03d}.png" for i in range(n_images)]
    mask_dir = os.path.join(root, "masks", "instance_ids_npy")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    for i, name in enumerate(names):
        write_png(os.path.join(root, "images", name), (imgs[i] * 255).astype(np.uint8))
        np.save(os.path.join(mask_dir, f"{os.path.splitext(name)[0]}_instance_id.npy"),
                masks[i])
    sel = rng.choice(n, size=min(n, sfm_points), replace=False)
    _write_colmap_sparse(os.path.join(root, "sparse", "0"), width, height,
                         1.05 * max(width, height), viewmats, names, means[sel],
                         s["colors"][sel])
    return dict(s, images=imgs, masks=masks)


def make_colmap_test_scene(root, n_images=8, width=64, height=48, n_pts=120,
                           seed=7, device: DeviceLike = None, tracks: bool = False):
    """A synthetic COLMAP scene (sparse/0 bin files + PNG images) whose
    images are 3DGS renders: trainable end to end in a few dozen steps.
    ``tracks``: each image tracks the points it sees (``visible_tracks``)."""
    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)

    pts = rng.normal(size=(n_pts, 3)).astype(np.float32) * 0.4 + [0, 0, 4.0]
    cols = rng.uniform(0.2, 1.0, size=(n_pts, 3)).astype(np.float32)

    f = 70.0 * (width / 64.0)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    viewmats = []
    for i in range(n_images):
        vm = np.eye(4, dtype=np.float32)
        vm[0, 3] = 0.4 * np.cos(2 * np.pi * i / n_images)
        vm[1, 3] = 0.4 * np.sin(2 * np.pi * i / n_images)
        viewmats.append(vm)
    viewmats = np.stack(viewmats)

    # ground-truth gaussians at the points
    quats = np.tile([1.0, 0, 0, 0], (n_pts, 1)).astype(np.float32)
    scales = np.full((n_pts, 3), 0.06, np.float32)
    opac = np.full((n_pts,), 0.95, np.float32)
    img = _render_gt(pts, quats, scales, opac, cols, viewmats,
                     np.tile(K, (n_images, 1, 1)), width, height, 0.0, device)

    names = [f"img_{i:03d}.png" for i in range(n_images)]
    for i in range(n_images):
        write_png(os.path.join(root, "images", names[i]), (img[i] * 255).astype(np.uint8))
    _write_colmap_sparse(sparse, width, height, f, viewmats, names, pts, cols,
                         tracks=(visible_tracks(pts, viewmats, f, width, height)
                                 if tracks else None))
    return {"means": pts, "colors": cols, "viewmats": viewmats, "K": K, "images": img}


def make_rich_scene(root, n_images=40, width=1236, height=822, n_gt=150_000,
                    sfm_points=40_000, seed=11, extent=4.0,
                    device: DeviceLike = None):
    """A visually rich procedural COLMAP scene that needs densification: a
    textured multi-frequency terrain with boxes, ellipsoids and thin
    pillars, seen from three orbit rings of cameras. A random subsample of
    the ground-truth gaussians plays the COLMAP triangulation
    (``sfm_points``)."""
    rng = np.random.default_rng(seed)
    S = extent

    def tex(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        r = 0.5 + 0.25 * np.sin(3.1 * x) * np.cos(2.3 * y) \
            + 0.15 * np.sin(9.7 * x + 5.1 * y)
        g = 0.5 + 0.25 * np.cos(2.7 * x + 1.1) * np.sin(3.7 * y) \
            + 0.15 * np.sin(8.3 * y + 3.7 * z)
        b = 0.45 + 0.3 * np.sin(1.9 * x + 2.9 * y + 4.1 * z) \
            + 0.1 * np.cos(11.3 * x)
        c = np.stack([r, g, b], -1)
        c += rng.uniform(-0.04, 0.04, c.shape)
        return np.clip(c, 0.02, 1.0).astype(np.float32)

    def terrain_z(xy):
        x, y = xy[:, 0], xy[:, 1]
        return (0.35 * np.sin(1.1 * x) * np.cos(0.9 * y)
                + 0.18 * np.sin(2.6 * x + 1.3) * np.sin(2.1 * y)
                + 0.08 * np.sin(5.3 * x + 2.1 * y)).astype(np.float32)

    n_ground = int(n_gt * 0.55)
    gxy = rng.uniform(-S, S, size=(n_ground, 2)).astype(np.float32)
    ground = np.concatenate([gxy, terrain_z(gxy)[:, None]], 1)

    n_obj = 28
    per_obj = (n_gt - n_ground) // n_obj
    objs, obj_scale_mult = [], []
    for i in range(n_obj):
        cx, cy = rng.uniform(-0.75 * S, 0.75 * S, 2)
        base_z = float(terrain_z(np.array([[cx, cy]], np.float32))[0])
        kind = i % 3
        if kind == 0:  # box
            he = rng.uniform(0.15, 0.55, 3)
            pts = _sample_box_surface(rng, per_obj, he)
            pts[:, 2] += he[2]
        elif kind == 1:  # ellipsoid
            he = rng.uniform(0.15, 0.5, 3)
            u = rng.normal(size=(per_obj, 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-9
            pts = (u * he).astype(np.float32)
            pts[:, 2] += he[2]
        else:  # thin pillar
            he = np.array([0.08, 0.08, rng.uniform(0.6, 1.2)])
            pts = _sample_box_surface(rng, per_obj, he)
            pts[:, 2] += he[2]
        pts[:, 0] += cx
        pts[:, 1] += cy
        pts[:, 2] += base_z
        objs.append(pts.astype(np.float32))
        obj_scale_mult.append(np.full(per_obj, 0.7, np.float32))

    means = np.concatenate([ground] + objs)
    n = means.shape[0]
    cols = tex(means)
    quats = np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32)
    g_scale = 2.2 * S / np.sqrt(n_ground)
    scales = np.full((n, 3), g_scale, np.float32)
    scales[n_ground:] *= np.concatenate(obj_scale_mult)[:, None] * 0.8
    opac = np.full((n,), 0.9, np.float32)

    center = np.array([0.0, 0.0, 0.25], np.float32)
    f = 0.82 * max(width, height)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)
    viewmats = []
    for i in range(n_images):
        az = 2 * np.pi * i / n_images * 3.0  # three loops
        ring = i * 3 // n_images
        el = np.deg2rad((18.0, 32.0, 50.0)[ring])
        radius = (1.45, 1.25, 1.1)[ring] * S
        eye = center + radius * np.array(
            [np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)], np.float32)
        viewmats.append(_look_at_viewmat(eye, center))
    viewmats = np.stack(viewmats)
    Ks = np.tile(K, (n_images, 1, 1))
    names = [f"img_{i:03d}.png" for i in range(n_images)]

    # exact tile coverage: no gaussian of the ground truth is cut
    imgs = _render_gt(means, quats, scales, opac, cols, viewmats, Ks, width,
                      height, 0.05, device, tile_capacity=2048, isect_exact=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(n_images):
        write_png(os.path.join(root, "images", names[i]),
                  (imgs[i] * 255).astype(np.uint8))

    sel = rng.choice(n, size=min(n, sfm_points), replace=False)
    _write_colmap_sparse(os.path.join(root, "sparse", "0"), width, height, f,
                         viewmats, names, means[sel], cols[sel])
    return {"means": means, "quats": quats, "scales": scales, "opacities": opac,
            "colors": cols, "viewmats": viewmats, "Ks": Ks}
