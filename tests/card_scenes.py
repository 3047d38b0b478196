"""Scenes, kernel inputs and tolerances shared by the port's card tests
(``tests/test_torch_kernel_card.py``, ``tests/test_torch_paths_card.py``,
``tests/test_torch_mcmc_noise.py``, ``tests/test_torch_ut_project.py``,
``tests/test_torch_surfel_project.py``) and
by ``kernel_times.py``, which times the kernels at the same shapes; and the
functions the sharded card tests' ranks run, which a spawned rank imports
by module.

The full-size scenes: the 200k-gaussian 1080p scene of the JAX package's
bench.py, a heavy-overlap scene whose tiles overflow a tile capacity of
128, and the 16-domino rally scene; the trained ones: the domino chain's
and the depth path's. Every function here but ``noise_state``,
``ut_scene``, ``ut_distortion`` and ``surfel_scene`` (which take a device) puts its tensors
on the card. Like the card tests, this module imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

import tdgs_torch
from tdgs_torch.main import default_camera
from tdgs_torch.models.gaussians import rgb_to_sh
from tdgs_torch.ops import _build
from tdgs_torch.ops import rasterize_2dgs_packed as R2
from tdgs_torch.ops import rasterize_eval3d_packed as E
from tdgs_torch.ops import rasterize_pallas as RP
from tdgs_torch.ops import segment_sum as S
from tdgs_torch.ops.camera_models import RollingShutterType
from tdgs_torch.ops.rasterize_packed import (
    KERNEL,
    KERNEL_BWD,
    rasterize_packed_bwd,
    rasterize_packed_train_fwd,
)
from tdgs_torch.ops.tiling import derive_isect_capacity
from tdgs_torch.rendering import _colors_per_camera
from tdgs_torch.strategy import DefaultStrategy
from tdgs_torch.training.config import Config
from tdgs_torch.utils.test_data import make_domino_scene_arrays

DEVICE = "cuda"
WIDTH, HEIGHT = 1920, 1080
TOL = 1e-3  # kernel vs plain version, absolute, colours and alphas
BWD_RTOL = 1e-3  # backward vs plain: max|Δ| / max|plain| per gradient group
SEG_RTOL = 1e-5  # kernel 3 vs plain: max|Δ| / max|plain| per column group
DIST_RTOL = 1e-3  # kernel 5 vs plain: distortion, max|Δ| / max|plain|
MEDIAN_SHARE = 0.01  # kernel 5 vs plain: share of pixels whose median differs
SIGMA_TOL = 1e-3  # eval3d σ* (float32, σ* < 4) vs float64, absolute
KERNELS = (KERNEL, KERNEL_BWD, S.KERNEL)
DENSE_KERNELS = (RP.KERNEL_FWD, RP.KERNEL_BWD, S.KERNEL)
BACKGROUND = (0.3, 0.5, 0.7)


def bench_scene(n=200_000, seed=0, scale_range=(0.005, 0.03)):
    """The 200k-gaussian 1080p scene of the JAX package's bench.py (numpy)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * np.array(
        [3.0, 2.0, 1.0], np.float32) + np.array([0, 0, 8.0], np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(*scale_range, size=(n, 3)).astype(np.float32)
    opacities = rng.uniform(0.3, 1.0, size=(n,)).astype(np.float32)
    sh = (rng.normal(size=(n, 16, 3)) * 0.2).astype(np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None]
    f = 1400.0
    Ks = np.array([[[f, 0, WIDTH / 2], [0, f, HEIGHT / 2], [0, 0, 1]]], np.float32)
    return dict(means=means, quats=quats, scales=scales, opacities=opacities,
                sh=sh, viewmats=viewmats, Ks=Ks)


def rally_scene(seed=3):
    """16 dominoes x 2500 gaussians on 10k ground disks, SH degree 3 (numpy)."""
    s = make_domino_scene_arrays(n_dominoes=16, n_images=1, width=WIDTH,
                                 height=HEIGHT, gauss_per_domino=2500,
                                 ground_gauss=10_000, seed=seed)
    rng = np.random.default_rng(seed + 1)
    n = s["means"].shape[0]
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = rgb_to_sh(s["colors"])
    sh[:, 1:] = rng.normal(size=(n, 15, 3)) * 0.05
    viewmat, K = default_camera(s["means"], WIDTH, HEIGHT)
    return dict(means=s["means"], quats=s["quats"], scales=s["scales"],
                opacities=s["opacities"], sh=sh, viewmats=viewmat[None],
                Ks=K[None], labels=s["labels"] - 1)


def to_card(scene):
    return {k: torch.as_tensor(v, device=DEVICE) for k, v in scene.items()}


def full_size_scenes():
    """The bench scene, the heavy-overlap scene (60k large gaussians) and
    the rally scene, on the card."""
    return dict(bench=to_card(bench_scene()),
                heavy=to_card(bench_scene(n=60_000, seed=1, scale_range=(0.05, 0.12))),
                rally=to_card(rally_scene()))


def background(D=3):
    bg = torch.tensor([BACKGROUND], device=DEVICE)
    return torch.cat([bg, bg.new_zeros((1, D - 3))], -1)


def camera_Ks(camera_model):
    """The bench view's intrinsics under ``camera_model``: the orthographic
    camera at 90 pixels a world unit (the scene's ±3σ in y fills the
    height) or the equidistant fisheye with f = 960 / (π / 2) (the width
    spans 180°)."""
    f = {"ortho": 0.5 * HEIGHT / 6.0, "fisheye": 0.5 * WIDTH / (np.pi / 2)}[camera_model]
    return torch.tensor([[[f, 0, WIDTH / 2], [0, f, HEIGHT / 2], [0, 0, 1]]],
                        dtype=torch.float32, device=DEVICE)


# ---------------------------------------------------------------------------
# kernels 1-3: the packed 3DGS composite, its backward, the segment sum
# ---------------------------------------------------------------------------


def kernel_inputs(sc, render_mode="RGB", backgrounds=None, width=WIDTH, height=HEIGHT, **kw):
    """Kernel 1's inputs for one frame, built by the port's own projection,
    SH and tiling (rasterization's meta + its colours): (args, backgrounds
    with the depth channel's zero where "RGB+ED", meta)."""
    _, _, meta = tdgs_torch.rasterization(
        sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
        sc["viewmats"], sc["Ks"], width, height, sh_degree=3,
        render_mode=render_mode, backgrounds=backgrounds, device=DEVICE, **kw)
    colors = _colors_per_camera(sc["sh"], 3, sc["means"], sc["viewmats"], meta["radii"])
    if render_mode == "RGB+ED":
        colors = torch.cat([colors, meta["depths"][..., None]], -1)
        if backgrounds is not None:
            backgrounds = torch.cat([backgrounds, backgrounds.new_zeros((1, 1))], -1)
    args = (meta["means2d"].contiguous(), meta["conics"].contiguous(),
            colors.contiguous(), meta["opacities"].contiguous(), width, height,
            meta["tile_size"], meta["isect_offsets"], meta["flatten_ids"])
    return args, backgrounds, meta


# name → (scene, tile_capacity, kernel_inputs' options): kernel 1's
# inference call at the shapes its full-size paths give it
KERNEL_1_CASES = {
    "a_bench_rgb": ("bench", 1024, dict(max_tiles_per_gauss=16)),
    "b_bench_rgb_ed_background": ("bench", 1024, dict(render_mode="RGB+ED", background=True,
                                                      max_tiles_per_gauss=16)),
    "c_heavy_overlap_truncated": ("heavy", 128, dict(isect_exact=True)),
    "d_domino_exact": ("rally", 1024, dict(isect_exact=True)),
    "ortho_bench": ("bench", 1024, dict(max_tiles_per_gauss=16, camera_model="ortho")),
    "fisheye_bench": ("bench", 1024, dict(max_tiles_per_gauss=16, camera_model="fisheye")),
}


def kernel_1_case(scenes, name):
    """(args, backgrounds, tile_capacity) of a ``KERNEL_1_CASES`` case."""
    scene, tc, kw = KERNEL_1_CASES[name]
    kw = dict(kw)
    sc = scenes[scene]
    if "camera_model" in kw:
        sc = dict(sc, Ks=camera_Ks(kw["camera_model"]))
    bg = background() if kw.pop("background", False) else None
    args, bg, _ = kernel_inputs(sc, backgrounds=bg, **kw)
    return args, bg, tc


def bench_capacity(bench):
    """The training path's stream capacity: the bench scene's intersections
    with 25% headroom (the role of derive_isect_capacity in the JAX
    package's bench.py)."""
    _, _, meta = tdgs_torch.rasterization(
        bench["means"], bench["quats"], bench["scales"], bench["opacities"],
        bench["sh"], bench["viewmats"], bench["Ks"], WIDTH, HEIGHT, sh_degree=3,
        tile_capacity=1024, max_tiles_per_gauss=16, device=DEVICE)
    return int(meta["n_isects"] * 1.25)


def train_stream(args, tile_capacity, seed):
    """Kernel 1's training call on ``args``, random cotangents, and kernel
    2's per-slot rows: (img, T, v_img, v_T, rows)."""
    img, trans = rasterize_packed_train_fwd(*args, tile_capacity=tile_capacity)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    v_img = torch.randn(img.shape, generator=g, device=DEVICE)
    v_t = torch.randn(trans.shape, generator=g, device=DEVICE)
    rows = rasterize_packed_bwd(*args, img, trans, v_img, v_t, tile_capacity=tile_capacity)
    return img, trans, v_img, v_t, rows


def train_case(scenes, name):
    """(args, tile_capacity, seed) of kernels 1-3 at the training path's
    full-size shapes: ``a_bench`` (200k gaussians, K = 16, its stream
    capacity) and ``b_heavy_overlap_truncated`` (tile_capacity 128)."""
    if name == "a_bench":
        bench = scenes["bench"]
        args, _, _ = kernel_inputs(bench, max_tiles_per_gauss=16,
                                   isect_capacity=bench_capacity(bench))
        return args, 1024, 1
    args, _, _ = kernel_inputs(scenes["heavy"], isect_exact=True)
    return args, 128, 2


# ---------------------------------------------------------------------------
# kernels 4-6: the 2DGS composites and backward
# ---------------------------------------------------------------------------


def kernel_inputs_2dgs(sc, render_mode="RGB+ED", distloss=True, width=WIDTH, height=HEIGHT,
                       **kw):
    """The 2DGS kernels' inputs for one frame, built by the port's own
    projection, SH and tiling (rasterization_2dgs's meta): ``geo``, the
    stream-order feature rows with the offsets, the image count, the
    channel count D (3 for "RGB", 4 with the depth channel that "RGB+ED"
    and distloss add) and the image's size, as kernels 5 and 6 take them;
    and ``k4``, the per-gaussian rows at the inference kernel's stride with
    the flatten ids and the rest of ``geo``, as kernel 4 takes them."""
    out = tdgs_torch.rasterization_2dgs(
        sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
        sc["viewmats"], sc["Ks"], width, height, sh_degree=3, render_mode=render_mode,
        distloss=distloss, device=DEVICE, **kw)
    meta = out[6]
    colors = _colors_per_camera(sc["sh"], 3, sc["means"], sc["viewmats"], meta["radii"])
    if distloss or render_mode == "RGB+ED":
        colors = torch.cat([colors, meta["depths"][..., None]], -1)
    D = colors.shape[-1]
    args = (meta["means2d"], meta["ray_transforms"], colors, meta["normals"],
            meta["opacities"])
    ids = meta["flatten_ids"]
    rows = R2.feature_rows(*args)[ids.long()].contiguous()
    rest = (meta["isect_offsets"], 1, D, width, height, meta["tile_size"])
    feats = R2.feature_rows(*args, width=R2.padded_width(D))
    return (rows,) + rest, (feats, ids) + rest


def bench_capacity_2dgs(bench):
    """The 2DGS training path's stream capacity: the bench scene's surfel
    intersections with 25% headroom."""
    out = tdgs_torch.rasterization_2dgs(
        bench["means"], bench["quats"], bench["scales"], bench["opacities"], bench["sh"],
        bench["viewmats"], bench["Ks"], WIDTH, HEIGHT, sh_degree=3, tile_capacity=1024,
        max_tiles_per_gauss=16, device=DEVICE)
    return int(out[6]["n_isects"] * 1.25)


# name → (scene, tile_capacity, seed, kernel_inputs_2dgs' options)
KERNEL_2DGS_CASES = {
    "a_bench_rgb": ("bench", 1024, 3, dict(render_mode="RGB", distloss=False)),
    "b_bench_rgb_ed_dist": ("bench", 1024, 3, {}),
    "c_heavy_overlap_truncated": ("heavy", 128, 4, dict(isect_exact=True)),
}


def kernel_2dgs_case(scenes, name):
    """(geo, k4, tile_capacity, seed) of a ``KERNEL_2DGS_CASES`` case: the
    bench cases at the bench render's stream capacity, K = 16."""
    scene, tc, seed, kw = KERNEL_2DGS_CASES[name]
    sc = scenes[scene]
    if scene == "bench":
        kw = dict(kw, max_tiles_per_gauss=16, isect_capacity=bench_capacity_2dgs(sc))
    geo, k4 = kernel_inputs_2dgs(sc, tile_capacity=tc, **kw)
    return geo, k4, tc, seed


def train_stream_2dgs(geo, tile_capacity, seed):
    """Kernel 5 on ``geo`` (the depth row last, the distortion on), random
    cotangents of its first four outputs: (outputs, cotangents)."""
    D = geo[3]
    train = R2.rasterize_2dgs_train_fwd(*geo, tile_capacity, D - 1, True)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    cot = [torch.randn(x.shape, generator=g, device=DEVICE) for x in train[:4]]
    return train, cot


# ---------------------------------------------------------------------------
# kernels 7 and 8: the eval3d (3DGUT) composite and backward
# ---------------------------------------------------------------------------


def rolling_shutter_kw(sc):
    """A TOP_TO_BOTTOM rolling shutter whose end pose has moved 2 cm along x
    and turned 0.5° about y, with the UT projection tiling it."""
    end = sc["viewmats"].clone()
    a = np.deg2rad(0.5)
    rot = torch.tensor([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                       dtype=torch.float32, device=end.device)
    end[:, :3, :3] = rot @ end[:, :3, :3]
    end[:, 0, 3] += 0.02
    return dict(with_ut=True, rolling_shutter=RollingShutterType.TOP_TO_BOTTOM,
                viewmats_rs=end)


def kernel_inputs_eval3d(sc, **kw):
    """Kernels 7 and 8's inputs for one frame, built by the port's own
    projection, SH, tiling, rays and rows (rasterization's meta): (rows,
    d, o', offsets, I, D, W, H, tile size), with the meta and the rolling
    shutter's options."""
    _, _, meta = tdgs_torch.rasterization(
        sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
        sc["viewmats"], sc["Ks"], WIDTH, HEIGHT, sh_degree=3, with_eval3d=True,
        device=DEVICE, **kw)
    colors = _colors_per_camera(sc["sh"], 3, sc["means"], sc["viewmats"], meta["radii"])
    rs = dict(rolling_shutter=kw.get("rolling_shutter", RollingShutterType.GLOBAL),
              viewmats_rs=kw.get("viewmats_rs"))
    ts = meta["tile_size"]
    d, o, o_ref = E.tile_rays_world(1, meta["tile_width"], meta["tile_height"], ts,
                                    WIDTH, HEIGHT, sc["viewmats"], sc["Ks"], **rs)
    N = sc["means"].shape[0]
    feats = E.feature_rows(sc["means"], sc["quats"], sc["scales"],
                           meta["opacities"].reshape(1, N), colors.reshape(1, N, -1), o_ref)
    rows = feats[meta["flatten_ids"].long()].contiguous()
    geo = (rows, d.contiguous(), None if o is None else o.contiguous(),
           meta["isect_offsets"], 1, colors.shape[-1], WIDTH, HEIGHT, ts)
    return geo, dict(meta=meta, rs=rs)


# name → (scene, tile_capacity, seed): the bench cases at the 3DGS bench
# render's stream capacity (the eval3d tiling of the bench frame is its)
KERNEL_EVAL3D_CASES = {
    "a_bench_rgb_central": ("bench", 1024, 5),
    "b_bench_rgb_rolling_shutter": ("bench", 1024, 6),
    "c_heavy_overlap_truncated": ("heavy", 128, 7),
}


def kernel_eval3d_case(scenes, name):
    """(geo, extra, tile_capacity, seed) of a ``KERNEL_EVAL3D_CASES`` case."""
    scene, tc, seed = KERNEL_EVAL3D_CASES[name]
    sc = scenes[scene]
    if scene == "heavy":
        kw = dict(isect_exact=True)
    else:
        kw = dict(max_tiles_per_gauss=16, isect_capacity=bench_capacity(sc))
        if name == "b_bench_rgb_rolling_shutter":
            kw.update(rolling_shutter_kw(sc))
    geo, extra = kernel_inputs_eval3d(sc, tile_capacity=tc, **kw)
    return geo, extra, tc, seed


def train_stream_eval3d(stream, tile_capacity, seed):
    """Kernel 7's training call on ``stream``, random cotangents: (img, T,
    v_img, v_T)."""
    img, T = E.rasterize_eval3d_train_fwd(*stream, tile_capacity)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    v_img = torch.randn(img.shape, generator=g, device=DEVICE)
    v_T = torch.randn(T.shape, generator=g, device=DEVICE)
    return img, T, v_img, v_T


# ---------------------------------------------------------------------------
# kernels 9 and 10: the tile-dense composite and backward
# ---------------------------------------------------------------------------


def dense_capacity(sc, max_tiles_per_gauss=16):
    """The dense tiling's isect_capacity for a scene, sized as the JAX
    package's bench.py:100-105 sizes it (derive_isect_capacity, 10%
    headroom)."""
    return derive_isect_capacity(sc["means"], sc["quats"], sc["scales"], sc["opacities"],
                                 sc["viewmats"], sc["Ks"], WIDTH, HEIGHT,
                                 max_tiles_per_gauss=max_tiles_per_gauss, device=DEVICE)


def dense_stream(rows, counts, geo, seed):
    """Kernel 9 on dense rows, random cotangents: (rows, counts, geo, img,
    T, v_img, v_T)."""
    img, trans = RP.rasterize_dense_fwd(rows, counts, *geo)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    v_img = torch.randn(img.shape, generator=g, device=DEVICE)
    v_t = torch.randn(trans.shape, generator=g, device=DEVICE)
    return rows, counts, geo, img, trans, v_img, v_t


def kernel_inputs_dense(sc, tile_capacity, seed, render_mode="RGB", **kw):
    """Kernels 9 and 10's inputs for one frame: the port's projection, SH
    and dense tiling (rasterization's meta with rasterizer="pallas"), the
    per-tile gather, then ``dense_stream``. Returns (inputs, meta)."""
    with torch.no_grad():
        _, _, meta = tdgs_torch.rasterization(
            sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
            sc["viewmats"], sc["Ks"], WIDTH, HEIGHT, sh_degree=3, render_mode=render_mode,
            rasterizer="pallas", tile_capacity=tile_capacity, device=DEVICE, **kw)
        colors = _colors_per_camera(sc["sh"], 3, sc["means"], sc["viewmats"], meta["radii"])
        if render_mode == "RGB+ED":
            colors = torch.cat([colors, meta["depths"][..., None]], -1)
        rows, counts = RP.dense_rows(meta["means2d"], meta["conics"], colors,
                                     meta["opacities"], meta["isect_offsets"],
                                     meta["flatten_ids"], meta["n_isects"], tile_capacity)
    return dense_stream(rows.contiguous(), counts, (1, WIDTH, HEIGHT, 16), seed), meta


def kernel_inputs_fitting(seed=9):
    """Kernels 9 and 10's inputs at the image-fitting example's shape: its
    first step (128x128, 2000 gaussians from ``init_params`` with the
    example's seed 42, tile_capacity 512, 64 tiles per gaussian), the
    forward's outputs and random cotangents."""
    from tdgs_torch import image_fitting as IF

    H = W = 128
    tc = 512
    p = IF.init_params(torch.Generator().manual_seed(42), 2000, device=DEVICE)
    viewmats, Ks = IF.build_camera(H, W, DEVICE)
    with torch.no_grad():
        colors = torch.sigmoid(p["colors"])
        _, _, meta = tdgs_torch.rasterization(
            p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]),
            colors, viewmats, Ks, W, H, rasterizer="pallas", tile_capacity=tc,
            max_tiles_per_gauss=64, device=DEVICE)
        rows, counts = RP.dense_rows(meta["means2d"], meta["conics"], colors[None],
                                     meta["opacities"], meta["isect_offsets"],
                                     meta["flatten_ids"], meta["n_isects"], tc)
    return dense_stream(rows.contiguous(), counts, (1, W, H, 16), seed)


# name → (scene, tile_capacity, seed, the background, kernel_inputs_dense's
# options); the bench cases at the dense capacity of the bench frame
KERNEL_DENSE_CASES = {
    "a_bench_rgb_background": ("bench", 1024, 5, True, {}),
    "b_bench_rgb_ed": ("bench", 1024, 6, False, dict(render_mode="RGB+ED")),
    "c_heavy_overlap_truncated": ("heavy", 128, 7, False, dict(max_tiles_per_gauss=32)),
    "d_image_fitting": (None, 512, 9, False, {}),
}


def kernel_dense_case(scenes, name):
    """(inputs, backgrounds, meta) of a ``KERNEL_DENSE_CASES`` case; meta
    is None at the image-fitting shape."""
    scene, tc, seed, with_bg, kw = KERNEL_DENSE_CASES[name]
    if scene is None:
        return kernel_inputs_fitting(seed), None, None
    sc = scenes[scene]
    k = kw.get("max_tiles_per_gauss", 16)
    kw = dict(kw, max_tiles_per_gauss=k, isect_capacity=dense_capacity(sc, k))
    inputs, meta = kernel_inputs_dense(sc, tc, seed, **kw)
    bg = torch.tensor(BACKGROUND, device=DEVICE) if with_bg else None
    return inputs, bg, meta


# ---------------------------------------------------------------------------
# the trained scenes: the domino chain (kernels 1-3 at D = 16, kernel 1 at
# its rally frame) and the depth path (kernels 1-3 at D = 4)
# ---------------------------------------------------------------------------


def trained_chain(root):
    """``python -m tdgs_torch.rally_e2e`` at the JAX example's defaults (6
    dominoes, 32 views of 480x360, capacity 24k, 2000 steps, identity_dim
    16; 90 rally frames at 1920x1080 on its derived tiling plan) written
    under ``root``, no GIF: its summary."""
    from tdgs_torch.rally_e2e import run_chain

    return run_chain(data_dir=f"{root}/data", out_dir=f"{root}/out", gif=None, device=DEVICE)


def chain_case(root, summary, name):
    """(args, backgrounds, tile_capacity) of kernel 1 on the chain's trained
    scene. ``identity_d16``: the identity render at D = 16 (the checkpoint's
    splats and head, the first training view, 480x360, K = 32, tile_capacity
    1024), as its training step calls kernels 1-3. ``e_trained_dominoes_2048``:
    the chain's rally frame (1920x1080, the PLY's splats, tile_capacity 2048,
    the chain's tiling plan), where the trained scene's products end near
    the 1e-4 cutoff."""
    import pickle

    from tdgs_torch.datasets import Dataset, Parser
    from tdgs_torch.pipeline import GaussianModel
    from tdgs_torch.segmentation.head import apply_segmentation_head, head_from_numpy
    from tdgs_torch.utils.test_data import DOMINO_BACKGROUND

    view = Dataset(Parser(f"{root}/data", factor=1, normalize=False), "train")[0]
    H, W = view["image"].shape[:2]
    vm = torch.as_tensor(view["viewmat"], device=DEVICE)
    K = torch.as_tensor(view["K"], device=DEVICE)
    if name == "identity_d16":
        with open(f"{root}/out/ckpts/ckpt_{summary['steps']}.pkl", "rb") as f:
            state = pickle.load(f)
        sp = {k: torch.as_tensor(v, device=DEVICE) for k, v in state["splats"].items()}
        head = head_from_numpy(state["segmentation_head"], device=DEVICE)
        with torch.no_grad():
            feats = apply_segmentation_head(head, sp["identity_encodings"])
            _, _, meta = tdgs_torch.rasterization(
                sp["means"], sp["quats"], torch.exp(sp["scales"]),
                torch.sigmoid(sp["opacities"]), feats, vm[None], K[None], W, H,
                rasterizer="packed", device=DEVICE)
        args = (meta["means2d"].contiguous(), meta["conics"].contiguous(),
                feats[None].contiguous(), meta["opacities"].contiguous(), W, H,
                meta["tile_size"], meta["isect_offsets"], meta["flatten_ids"])
        return args, None, 1024
    splats = GaussianModel(sh_degree=3, device=DEVICE).load_splats_from_ply(
        f"{root}/out/scene.ply")
    K_r = K.clone()
    K_r[0] *= WIDTH / W
    K_r[1] *= HEIGHT / H
    frame = dict(means=splats["means"], quats=splats["quats"],
                 scales=torch.exp(splats["scales"]), opacities=torch.sigmoid(splats["opacities"]),
                 sh=torch.cat([splats["sh0"], splats["shN"]], dim=-2), viewmats=vm[None],
                 Ks=K_r[None])
    bg = torch.full((1, 3), DOMINO_BACKGROUND, device=DEVICE)
    args, bg, _ = kernel_inputs(frame, backgrounds=bg, tile_capacity=2048,
                                **summary["isect_plan"])
    return args, bg, 2048


# the depth path's Runner: dense depths from the refined maps, the
# depth-normal regularizers and the monocular normals from step 30, and the
# depth and normal dumps at the tb_every cadence
DEPTH_TERMS = dict(depth_loss=True, use_precomputed_depths=True, depth_normal_loss=True,
                   depth_normal_start_step=30, load_normals=True, start_normal_loss_step=30,
                   save_depth_normal_vis=True)


def write_depth_maps(root, gt):
    """The rich scene's refined depths and normal maps, as a depth or
    normal estimator would give them: the ground-truth gaussians rendered in
    "ED" at every view through kernel 1 (exact coverage, tile_capacity
    2048) into refined_depths/{stem}_refined_depth.npy, and the world
    normals of those depths into normals/{stem}.npy, both in the frame the
    Runner's Parser normalizes to. Returns (the normalization's
    determinant, the least coverage of a view, kernel 1's launches, views)."""
    from tdgs_torch.datasets import Parser
    from tdgs_torch.utils.depth import depth_to_normal, rotate

    parser = Parser(root, factor=1)
    T = parser.transform[:3, :3]
    det = float(np.linalg.det(T))
    scale = abs(det) ** (1.0 / 3.0)
    R = torch.as_tensor(T / scale, dtype=torch.float32, device=DEVICE)
    for sub in ("refined_depths", "normals"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    sc = to_card({k: gt[k] for k in ("means", "quats", "scales", "opacities", "colors")})
    W, H = parser.imsize_dict[parser.camera_ids[0]]
    _build.reset_launches()
    coverage = []
    for i, name in enumerate(parser.image_names):
        vm = torch.as_tensor(gt["viewmats"][i], device=DEVICE)
        K = torch.as_tensor(gt["Ks"][i], device=DEVICE)
        depth, _, _ = tdgs_torch.rasterization(
            sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["colors"], vm[None],
            K[None], W, H, render_mode="ED", rasterizer="packed_inference",
            tile_capacity=2048, isect_exact=True, device=DEVICE)
        normals = rotate(R, depth_to_normal(depth[0], torch.linalg.inv(vm), K))
        stem = os.path.splitext(name)[0]
        d = (depth[0, ..., 0] * scale).cpu().numpy()
        np.save(os.path.join(root, "refined_depths", f"{stem}_refined_depth.npy"), d)
        np.save(os.path.join(root, "normals", f"{stem}.npy"), normals.cpu().numpy())
        coverage.append(float((d > 0).mean()))
    return det, min(coverage), _build.LAUNCHES.get(KERNEL, 0), len(parser.image_names)


def depth_kernel_inputs(runner, view=0):
    """Kernels 1-3's operands on the depth path's stream: the Runner's
    splats rendered to training view ``view`` in "RGB+ED" as its step renders
    them (the packed tiling at its capacities), the SH colours with the
    depths as the fourth channel."""
    from tdgs_torch.models.gaussians import splat_activations

    cfg = runner.cfg
    d = runner.trainset[view]
    H, W = d["image"].shape[:2]
    vm = torch.as_tensor(d["viewmat"], device=DEVICE)[None]
    K = torch.as_tensor(d["K"], device=DEVICE)[None]
    with torch.no_grad():
        means, quats, scales, opacities, sh = splat_activations(runner.splats)
        _, _, meta = tdgs_torch.rasterization(
            means, quats, scales, opacities, sh, vm, K, W, H, sh_degree=cfg.sh_degree,
            render_mode="RGB+ED", rasterizer="packed", tile_capacity=cfg.tile_capacity,
            isect_capacity=cfg.isect_capacity, max_tiles_per_gauss=cfg.max_tiles_per_gauss,
            device=DEVICE)
        colors = torch.cat([_colors_per_camera(sh, cfg.sh_degree, means, vm, meta["radii"]),
                            meta["depths"][..., None]], -1)
    return (meta["means2d"].contiguous(), meta["conics"].contiguous(), colors.contiguous(),
            meta["opacities"].contiguous(), W, H, meta["tile_size"], meta["isect_offsets"],
            meta["flatten_ids"])


# ---------------------------------------------------------------------------
# the MCMC position noise (12): the state it perturbs
# ---------------------------------------------------------------------------

NOISE_SCALER = 160.0  # lr · noise_lr of the benchmark's cells at step 5,200, about


def noise_state(n, seed=0, device="cpu"):
    """Rows drawn as ``portbench/scenes/state.py`` draws the trained state
    (anisotropic splats of the surfaces' spacing, 1% at 2.5×, 5%
    near-transparent), quaternions left unnormalized as Adam leaves them,
    the SH groups along; and the noise."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    def rand(*shape):
        return torch.rand(shape, generator=g)

    log_s = torch.log(torch.tensor(0.012)) + 0.35 * randn(n, 3)
    log_s[:, 2] += torch.log(torch.tensor(0.3))
    log_s = log_s + (rand(n) < 0.01)[:, None] * torch.log(torch.tensor(2.5))
    op = torch.sigmoid(1.0 + 1.5 * randn(n))
    op = torch.where(rand(n) < 0.05, 0.001 + 0.003 * rand(n), op)
    params = {
        "means": 1.5 * randn(n, 3),
        "quats": randn(n, 4) * (0.5 + rand(n, 1)),
        "scales": log_s,
        "opacities": torch.logit(op),
        "sh0": randn(n, 1, 3),
        "shN": 0.02 * randn(n, 15, 3),
    }
    noise = randn(n, 3)
    return {k: v.to(device) for k, v in params.items()}, noise.to(device)


# ---------------------------------------------------------------------------
# the UT projection's kernel: its scene and cameras
# ---------------------------------------------------------------------------

UT_WIDTH, UT_HEIGHT = 1236, 822  # the 3DGUT cell's image (bicycle at data factor 4)
UT_FOCAL = 1100.0
UT_GROUPS = ("regular", "behind", "near_plane", "off_image", "large", "degenerate")


def turned_cameras(n_cams, focal, cx, cy):
    """``n_cams`` pinhole cameras (numpy): the first at the origin looking
    down +z, the others turned 6° and -9° about y and moved a little."""
    viewmats = np.tile(np.eye(4), (n_cams, 1, 1))
    for i, (deg, shift) in enumerate(((6.0, (0.3, -0.1, 0.2)), (-9.0, (-0.4, 0.2, -0.3)))
                                     [:n_cams - 1], start=1):
        a = np.deg2rad(deg)
        viewmats[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        viewmats[i, :3, 3] = shift
    return viewmats, np.tile([[focal, 0, cx], [0, focal, cy], [0, 0, 1]], (n_cams, 1, 1))


def ut_scene(n, n_cams=1, seed=0, device="cpu"):
    """``n`` gaussians for ``n_cams`` 1236x822 pinhole cameras (f = 1100;
    the first at the origin looking down +z, the others turned 6° and -9°
    and moved a little), as ``project_ut_for_tiles`` takes them (activated
    scales and opacities), in groups (``group``, indexing ``UT_GROUPS``):
    78% regular (2-12 units deep, scales 0.005-0.1, over the image and 300
    px beyond); 5% the regular rows mirrored behind the camera; 5% at the
    near plane (depth 0.01 ± 0.004, scales 1e-4-5e-4); 5% small, 700-1000
    px off the image, beyond any margin; 5% large and close (scales
    0.3-0.8, 3.5-6 deep, radii of hundreds of pixels); 2% degenerate (zero
    scales, or a zero quaternion). 3% of the opacities lie below 1/255.
    Through the pinhole every sigma point lands within (-1100, 2048)
    pixels, where float32 keeps a pixel to 1.2e-4."""
    rng = np.random.default_rng(seed)
    cx, cy = UT_WIDTH / 2, UT_HEIGHT / 2
    group = rng.choice(len(UT_GROUPS), size=n, p=[0.78, 0.05, 0.05, 0.05, 0.05, 0.02])
    u = rng.uniform(-300, UT_WIDTH + 300, n)
    v = rng.uniform(-300, UT_HEIGHT + 300, n)
    z = rng.uniform(2.0, 12.0, n)
    scales = np.exp(rng.uniform(np.log(0.005), np.log(0.1), (n, 3)))
    near = group == 2
    z[near] = 0.01 + rng.uniform(-0.004, 0.004, near.sum())
    scales[near] = rng.uniform(1e-4, 5e-4, (near.sum(), 3))
    off = group == 3
    u[off] = np.where(rng.random(off.sum()) < 0.5, rng.uniform(-1000, -700, off.sum()),
                      rng.uniform(UT_WIDTH + 700, UT_WIDTH + 800, off.sum()))
    scales[off] = rng.uniform(0.005, 0.02, (off.sum(), 3))
    large = group == 4
    z[large] = rng.uniform(3.5, 6.0, large.sum())
    scales[large] = rng.uniform(0.3, 0.8, (large.sum(), 3))
    means = np.stack([(u - cx) / UT_FOCAL * z, (v - cy) / UT_FOCAL * z, z], -1)
    means[group == 1] *= -1.0
    quats = rng.normal(size=(n, 4))
    degenerate = np.flatnonzero(group == 5)
    scales[degenerate[::2]] = 0.0
    quats[degenerate[1::2]] = 0.0
    opacities = rng.uniform(0.0, 1.0, n)
    low = rng.random(n) < 0.03
    opacities[low] = rng.uniform(0.0, 0.004, low.sum())

    viewmats, Ks = turned_cameras(n_cams, UT_FOCAL, cx, cy)
    out = dict(means=means, quats=quats, scales=scales, opacities=opacities,
               viewmats=viewmats, Ks=Ks)
    out = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in out.items()}
    out["group"] = torch.as_tensor(group, device=device)
    return out


def ut_distortion(n_cams, terms=("radial", "tangential", "thin_prism"), fisheye=False,
                  device="cpu"):
    """Per-camera distortion coefficients of ``terms``, as keyword
    arguments: the OpenCV rational radial k1..k6 (fisheye: k1..k4),
    tangential p1 p2 and thin prism s1..s4, of the size a real lens has."""
    coeffs = {"radial": (0.05, 0.01, -0.002, 0.0, 0.0, 0.0) if fisheye else
              (0.12, -0.05, 0.01, 0.04, -0.01, 0.002),
              "tangential": (1e-3, -5e-4), "thin_prism": (5e-4, -2e-4, 3e-4, 1e-4)}
    return {f"{t}_coeffs": torch.tensor([coeffs[t][:4] if fisheye else coeffs[t]] * n_cams,
                                        dtype=torch.float32, device=device)
            for t in terms}


# ---------------------------------------------------------------------------
# the surfel projection's kernels: their scene and cameras
# ---------------------------------------------------------------------------

SURFEL_WIDTH, SURFEL_HEIGHT = 1297, 840  # the 2DGS cell's image (garden at data factor 4)
SURFEL_FOCAL = 1150.0
SURFEL_GROUPS = UT_GROUPS + ("camera_plane",)


def surfel_scene(n, n_cams=1, seed=0, device="cpu", dtype=torch.float32):
    """``n`` surfels for ``n_cams`` 1297x840 pinhole cameras (f = 1150; the
    first at the origin looking down +z, the others turned 6° and -9° and
    moved a little), as ``fully_fused_projection_2dgs`` takes them
    (activated scales), in groups (``group``, indexing ``SURFEL_GROUPS``):
    75% regular (2-12 units deep, scales 0.005-0.1, over the image and 300
    px beyond); 5% the regular rows mirrored behind the camera; 5% at the
    near plane (depth 0.01 ± 0.004, scales 1e-4-5e-4); 5% small, 700-1000
    px off the image; 5% large and close (scales 0.3-0.8, 0.5-6 deep, some
    crossing the camera's plane); 2% degenerate (zero scales, or a zero
    quaternion); 3% in the first camera's plane (depth 0, turned about the
    view axis alone: d = 0 there). Random orientations turn the normals
    both ways."""
    rng = np.random.default_rng(seed)
    cx, cy = SURFEL_WIDTH / 2, SURFEL_HEIGHT / 2
    group = rng.choice(len(SURFEL_GROUPS), size=n, p=[0.75, 0.05, 0.05, 0.05, 0.05, 0.02, 0.03])
    u = rng.uniform(-300, SURFEL_WIDTH + 300, n)
    v = rng.uniform(-300, SURFEL_HEIGHT + 300, n)
    z = rng.uniform(2.0, 12.0, n)
    scales = np.exp(rng.uniform(np.log(0.005), np.log(0.1), (n, 3)))
    near = group == 2
    z[near] = 0.01 + rng.uniform(-0.004, 0.004, near.sum())
    scales[near] = rng.uniform(1e-4, 5e-4, (near.sum(), 3))
    off = group == 3
    u[off] = np.where(rng.random(off.sum()) < 0.5, rng.uniform(-1000, -700, off.sum()),
                      rng.uniform(SURFEL_WIDTH + 700, SURFEL_WIDTH + 1000, off.sum()))
    scales[off] = rng.uniform(0.005, 0.02, (off.sum(), 3))
    large = group == 4
    z[large] = rng.uniform(0.5, 6.0, large.sum())
    scales[large] = rng.uniform(0.3, 0.8, (large.sum(), 3))
    means = np.stack([(u - cx) / SURFEL_FOCAL * z, (v - cy) / SURFEL_FOCAL * z, z], -1)
    means[group == 1] *= -1.0
    quats = rng.normal(size=(n, 4))
    degenerate = np.flatnonzero(group == 5)
    scales[degenerate[::2]] = 0.0
    quats[degenerate[1::2]] = 0.0
    plane = group == 6
    means[plane, 2] = 0.0
    quats[plane, 1:3] = 0.0

    viewmats, Ks = turned_cameras(n_cams, SURFEL_FOCAL, cx, cy)
    out = dict(means=means, quats=quats, scales=scales, viewmats=viewmats, Ks=Ks)
    out = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in out.items()}
    out["group"] = torch.as_tensor(group, device=device)
    return out


# ---------------------------------------------------------------------------
# the Runner's cells on the rich scene, and the sharded Runner's rank
# ---------------------------------------------------------------------------


def cell_config(root, name, n_steps, strategy=None, rasterizer="packed", tb_every=10,
                **extra):
    """The trainer cell's configuration (packed, SH 3, DefaultStrategy
    refining at 40 and 80, or ``strategy``) with ``extra`` options, logging
    every ``tb_every`` steps."""
    strategy = strategy or DefaultStrategy(refine_start_iter=20, refine_every=40,
                                           refine_stop_iter=1000, reset_every=10_000)
    return Config(data_dir=root, result_dir=f"{root}/results_{name}", data_factor=1,
                  max_steps=n_steps, eval_steps=[], save_steps=[], sh_degree=3,
                  sh_degree_interval=20, rasterizer=rasterizer, tb_every=tb_every,
                  strategy=strategy, **extra)


def trees_equal(a, b) -> bool:
    """Nested dicts of arrays and builtins equal bit for bit."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def sharded_config(root, n_steps, sharded):
    """The trainer cell's Runner at batch 2, sharded or on one device, the
    sharded checkpoint container, logging every step."""
    return cell_config(root, f"trainer_sharded_{int(sharded)}", n_steps, tb_every=1,
                       batch_size=2, sharded=sharded, ckpt_format="orbax")


def sharded_runner_rank(root, n_steps):
    """One rank of the sharded trainer cell (a ``parallel.launch.run``
    world): the sharded Runner trains ``n_steps``, evaluates, saves the
    sharded checkpoint, and a fresh sharded Runner reads it back. Returns
    the rank's record."""
    from tdgs_torch.training.trainer import Runner

    cfg = sharded_config(root, n_steps, True)
    runner = Runner(cfg, device=DEVICE)
    rank = runner.mesh.rank
    _build.reset_launches()
    hist = runner.train()["history"]
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES.get(k, 0) for k in KERNELS}
    stats = runner.eval(n_steps)
    path = runner.save_checkpoint(n_steps)
    saved = runner.state_numpy(n_steps)
    runner.trainset.close()
    fresh = Runner(cfg, device=DEVICE)
    step = fresh.load_checkpoint(path)
    loaded = fresh.state_numpy(n_steps)
    fresh.trainset.close()
    return dict(rank=rank, history=hist, launches=launches, eval_psnr=stats["psnr"],
                refines=runner.refines, result_dir=cfg.result_dir,
                ckpt_roundtrip_bitwise=bool(step == n_steps and trees_equal(saved, loaded)),
                all_finite=all(bool(torch.isfinite(v).all()) for v in runner.splats.values()))


# ---------------------------------------------------------------------------
# the sharded render at full size: one rank of a parallel.launch.run world
# ---------------------------------------------------------------------------

# name → (family, rasterizer, render mode, with the backward, its kernels)
SHARDED_CASES = {
    "3dgs_packed": ("3dgs", "packed", "RGB", True, KERNELS),
    "3dgs_packed_inference": ("3dgs", "packed_inference", "RGB", False, (KERNEL,)),
    "2dgs_packed": ("2dgs", "packed", "RGB+ED", True, (R2.KERNEL_TRAIN, R2.KERNEL_BWD, S.KERNEL)),
    "2dgs_packed_inference": ("2dgs", "packed_inference", "RGB", False, (R2.KERNEL_FWD,)),
    "eval3d": ("eval3d", None, "RGB", True, (E.KERNEL_TRAIN, E.KERNEL_BWD, S.KERNEL)),
    "pallas": ("3dgs", "pallas", "RGB", True, DENSE_KERNELS),
}


def sharded_scene(n=200_000):
    """The bench scene seen by two cameras 0.3 apart along x (numpy)."""
    sc = bench_scene(n=n)
    f = 1400.0
    viewmats = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    viewmats[1, 0, 3] = 0.3
    sc["viewmats"] = viewmats
    sc["Ks"] = np.tile(np.array([[f, 0, WIDTH / 2], [0, f, HEIGHT / 2], [0, 0, 1]],
                                np.float32), (2, 1, 1))
    return sc


def sharded_render_rank(names, caps, n_steps):
    """One rank of the full-size sharded render: each case's sharded render
    of this rank's camera from its block of the sharded scene (forward, and
    the backward of the outputs' means where the case trains) ``n_steps``
    times, with its kernels' launches; then the single-rank render of the
    same camera from every gaussian, whose gradients summed over the ranks
    are held against the sharded ones. Returns the rank's backend and, per
    case, its launches, its largest errors, n_dropped on both sides and
    whether every output and gradient is finite."""
    from tdgs_torch.parallel import comm, make_mesh
    from tdgs_torch.parallel import sharded_render as SR
    from tdgs_torch.utils.depth import rotate

    mesh = make_mesh(device=DEVICE)
    D, r = mesh.world, mesh.rank
    sc = {k: torch.as_tensor(v, device=mesh.device) for k, v in sharded_scene().items()}
    C, N = sc["viewmats"].shape[0], sc["means"].shape[0]
    c, n = C // D, N // D
    cams, rows = slice(r * c, (r + 1) * c), slice(r * n, (r + 1) * n)
    vm, Ks = sc["viewmats"][cams], sc["Ks"][cams]
    names_in = ("means", "quats", "scales", "opacities", "sh")
    out = {"rank": r, "world": D, "backend": mesh.backend, "cases": {}}
    for name in names:
        kind, rasterizer, mode, train, kernels = SHARDED_CASES[name]
        kw = dict(sh_degree=3, tile_capacity=1024, max_tiles_per_gauss=16, render_mode=mode,
                  isect_capacity=caps.get(name))
        if kind != "eval3d":
            kw["rasterizer"] = rasterizer
        if kind == "2dgs":
            kw["distloss"] = train  # kernel 5's distortion, on both sides
        local = [sc[k][rows].clone().requires_grad_(train) for k in names_in]
        fn = {"3dgs": SR.rasterization_sharded, "2dgs": SR.rasterization_2dgs_sharded,
              "eval3d": SR.rasterization_eval3d_sharded}[kind]
        _build.reset_launches()
        for _ in range(n_steps):
            with torch.set_grad_enabled(train):
                o = fn(*local, vm, Ks, WIDTH, HEIGHT, mesh, **kw)
                outs, meta = (o[:4] if kind == "2dgs" else o[:2]), o[-1]
                grads = (torch.autograd.grad(sum(x.mean() for x in outs), local)
                         if train else None)
        torch.cuda.synchronize()
        launches = {k: _build.LAUNCHES.get(k, 0) for k in kernels}

        full = [sc[k].clone().requires_grad_(train) for k in names_in]
        skw = dict(kw, device=mesh.device)
        with torch.set_grad_enabled(train):
            if kind == "2dgs":
                o = tdgs_torch.rasterization_2dgs(*full, vm, Ks, WIDTH, HEIGHT, **skw)
                souts, smeta = (o[0], o[1], rotate(vm[:, :3, :3], o[2]), o[4]), o[6]
            else:
                o = tdgs_torch.rasterization(*full, vm, Ks, WIDTH, HEIGHT,
                                             with_eval3d=kind == "eval3d", **skw)
                souts, smeta = o[:2], o[2]
            sgrads = (torch.autograd.grad(sum(x.mean() for x in souts), full)
                      if train else None)
        fwd = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(outs, souts))
        finite = all(bool(torch.isfinite(a).all()) for a in outs)
        bwd_rel = {}
        if train:
            for k, g, sg in zip(names_in, grads, sgrads):
                want = comm.all_reduce_sum(sg)[rows]
                finite = finite and bool(torch.isfinite(g).all())
                bwd_rel[k] = float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        out["cases"][name] = dict(launches=launches, max_abs_err=fwd, max_rel_err=bwd_rel,
                                  finite=finite, n_dropped=int(meta["n_dropped"].sum()),
                                  single_n_dropped=int(smeta["n_dropped"]))
    return out
