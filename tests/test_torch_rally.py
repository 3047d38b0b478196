"""Port parity for the rally frame: ``tdgs_torch``'s per-frame
step/render loop against ``tdgs``'s jitted ``make_step_and_render`` on the
same bodies (carried across with ``tdgs_torch.convert``), plus the import
guard (the port never loads JAX or the JAX package) and the port's own
entry points on the CPU."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tdgs
import tdgs_torch
from tdgs.physics import PhysicsParams as JParams
from tdgs.physics import extract_bodies_from_splats as j_extract
from tdgs.physics import make_step_and_render as j_make_step_and_render
from tdgs.physics.bodies import initial_state as j_initial_state
from tdgs.physics.bodies import settle_on_ground as j_settle
from tdgs.physics.splat_binding import labels_to_body_ids
from tdgs_torch import convert
from tdgs_torch.main import default_camera
from tdgs_torch.physics import (
    PhysicsParams,
    make_step_and_render,
)
from tdgs_torch.utils.test_data import DOMINO_BACKGROUND, make_domino_scene_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48
# body state: index_add_ vs XLA scatter-add summation order (see
# test_torch_physics.py); frames: the compositing tolerance of
# test_torch_rasterize_packed.py
STATE_ATOL = 1e-4
FRAME_ATOL = 2e-3


def _rally_scene():
    scene = make_domino_scene_arrays(n_dominoes=4, n_images=1, width=W, height=H,
                                     gauss_per_domino=200, ground_gauss=200, seed=5,
                                     spacing=0.42)
    rng = np.random.default_rng(700)
    n = scene["means"].shape[0]
    # the default camera looks straight at the domino faces, where every
    # gaussian of a face has the same depth; the JAX sort orders such ties
    # arbitrarily (either order is a valid composite), so break them
    scene["means"] += rng.normal(size=scene["means"].shape).astype(np.float32) * 1e-3
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = (scene["colors"] - 0.5) / 0.2820947917738781
    sh[:, 1:] = rng.normal(size=(n, 15, 3)) * 0.05
    labels = scene["labels"] - 1  # ground → background
    return scene, sh, labels


def test_rally_frames_match():
    scene, sh, labels = _rally_scene()
    means, quats = scene["means"], scene["quats"]
    scales, opac = scene["scales"], scene["opacities"]
    bodies, groups = j_extract(means, quats, scales, opac, labels)
    bodies = j_settle(bodies)
    body_ids = labels_to_body_ids(labels, groups)
    viewmat, K = default_camera(means, W, H)
    params, substeps = JParams(dt=1.0 / 240), 2
    raster_kw = dict(sh_degree=3, rasterizer="packed_inference", tile_capacity=256,
                     isect_exact=True)
    bg = np.full((1, 3), DOMINO_BACKGROUND, np.float32)

    def j_render(m, q):
        img, alpha, _ = tdgs.rasterization(
            m, q, jnp.asarray(scales), jnp.asarray(opac), jnp.asarray(sh),
            jnp.asarray(viewmat)[None], jnp.asarray(K)[None], W, H,
            backgrounds=jnp.asarray(bg), **raster_kw,
        )
        return img, alpha

    j_step = j_make_step_and_render(
        {"means": jnp.asarray(means), "quats": jnp.asarray(quats)},
        jnp.asarray(body_ids), bodies, j_render, params=params, substeps=substeps,
    )
    j_state = j_initial_state(bodies)
    j_state = j_state._replace(w=j_state.w.at[0, 1].set(4.0))

    dev = "cpu"
    t_bodies = convert.bodies_from_numpy(
        {f: np.asarray(getattr(bodies, f)) for f in bodies._fields}, device=dev)
    t_splats = convert.splats_from_numpy({"means": means, "quats": quats}, device=dev)
    t_scales, t_opac, t_sh = (torch.from_numpy(a) for a in (scales, opac, sh))

    def t_render(m, q):
        img, alpha, _ = tdgs_torch.rasterization(
            m, q, t_scales, t_opac, t_sh, viewmat[None], K[None], W, H,
            backgrounds=bg, device=dev, **raster_kw,
        )
        return img, alpha

    t_step = make_step_and_render(
        t_splats, torch.from_numpy(body_ids), t_bodies, t_render,
        params=PhysicsParams(dt=1.0 / 240), substeps=substeps,
    )
    t_state = convert.state_from_numpy(
        {f: np.asarray(getattr(j_state, f)) for f in j_state._fields}, device=dev)

    for frame in range(3):
        j_state, j_img, j_alpha = j_step(j_state)
        t_state, t_img, t_alpha = t_step(t_state)
        for f in ("x", "q", "v", "w"):
            np.testing.assert_allclose(getattr(t_state, f).numpy(),
                                       np.asarray(getattr(j_state, f)),
                                       atol=STATE_ATOL, err_msg=f"{f} @ {frame}")
        np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=FRAME_ATOL)
        np.testing.assert_allclose(t_alpha.numpy(), np.asarray(j_alpha),
                                   atol=FRAME_ATOL)
    assert float(np.abs(t_state.w[0].numpy()).max()) > 0.1  # the push is live
    assert float(t_alpha.mean()) > 0.05  # the frame shows the scene


def test_domino_scene_arrays_match_reference(tmp_path):
    from tdgs.utils.test_data import make_domino_scene

    kw = dict(n_dominoes=2, n_images=2, width=32, height=24, gauss_per_domino=40,
              ground_gauss=60, seed=9)
    want = make_domino_scene(str(tmp_path), sfm_points=10, **kw)
    got = make_domino_scene_arrays(**kw)
    for k in ("means", "quats", "scales", "opacities", "colors", "labels",
              "viewmats", "Ks", "half_extents"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


_GUARD = """
import sys
import tdgs_torch, tdgs_torch.main, tdgs_torch.pipeline, tdgs_torch.convert
import tdgs_torch.physics, tdgs_torch.utils.ply, tdgs_torch.utils.test_data
import tdgs_torch.segmentation.clustering, tdgs_torch.ops._build
import tdgs_torch.ops.segment_sum, tdgs_torch.ops.adam, tdgs_torch.utils.png
import tdgs_torch.models.gaussians, tdgs_torch.strategy, tdgs_torch.strategy.ops
import tdgs_torch.training.losses, tdgs_torch.training.config
import tdgs_torch.training.trainer, tdgs_torch.datasets, tdgs_torch.simple_trainer
import tdgs_torch.ops.projection_2dgs, tdgs_torch.ops.rasterize_2dgs_packed
import tdgs_torch.utils.depth, tdgs_torch.ops.rasterize_jax
import tdgs_torch.ops.rasterize_pallas, tdgs_torch.image_fitting
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "tdgs"
             or m.startswith("tdgs.") or m == "optax" or m.startswith("optax."))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_tdgs():
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax_and_no_tdgs():
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "tdgs" not in roots, sorted(names)
    assert "tdgs_torch" in roots


def test_main_cli_rally_on_cpu(tmp_path):
    """PLY + cluster groups → bodies → two rally frames, through the
    port's command line, on the CPU."""
    from PIL import Image

    from tdgs_torch.main import main
    from tdgs_torch.segmentation.clustering import save_cluster_groups
    from tdgs_torch.utils.ply import save_ply

    scene, sh, labels = _rally_scene()
    n = scene["means"].shape[0]
    ply = str(tmp_path / "scene.ply")
    save_ply(ply, scene["means"], np.log(scene["scales"]), scene["quats"],
             np.log(scene["opacities"] / (1 - scene["opacities"])),
             sh[:, :1], sh[:, 1:4])  # degree 1 in the file, padded on load
    clusters = str(tmp_path / "clusters.npz")
    save_cluster_groups(clusters, {"labels": labels})
    out = str(tmp_path / "rally.gif")
    main(["--ply", ply, "--clusters", clusters, "--simulate", "--frames", "2",
          "--push", "0:4.0", "--width", "48", "--height", "32", "--device", "cpu",
          "--exact-tiles", "--out", out])
    with Image.open(out) as im:
        assert im.size == (48, 32) and im.n_frames == 2
    single = str(tmp_path / "one.png")
    main(["--ply", ply, "--clusters", clusters, "--select", "1", "--width", "48",
          "--height", "32", "--device", "cpu", "--out", single])
    with Image.open(single) as im:
        assert np.asarray(im).max() > 0
    assert n == 1000


def test_ply_and_cluster_io_match_reference(tmp_path):
    from tdgs.segmentation.clustering import load_cluster_groups as j_load_groups
    from tdgs.utils.ply import load_ply as j_load_ply
    from tdgs_torch.segmentation.clustering import save_cluster_groups
    from tdgs_torch.utils.ply import load_ply, save_ply

    rng = np.random.default_rng(701)
    n = 50
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((n, 3), (n, 3), (n, 4), (n,), (n, 1, 3), (n, 15, 3))]
    ply = str(tmp_path / "s.ply")
    save_ply(ply, *arrays, extra={"identity_encodings": rng.normal(size=(n, 4))})
    got, want = load_ply(ply), j_load_ply(ply)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["shN"], arrays[5])
    path = str(tmp_path / "groups.npz")
    save_cluster_groups(path, {"labels": rng.integers(-1, 4, size=n)})
    groups = j_load_groups(path)
    assert "background" in groups and len(groups) == 5


@pytest.mark.parametrize("subset", [False, True])
def test_pipeline_helpers_match_reference(subset):
    """apply_transform (all splats, or a subset about a given centre) and the
    raw-parameter helpers against the JAX package's (atol 1e-6: float32
    rounding of the same elementwise formulas)."""
    from tdgs.models import gaussians as jg
    from tdgs.pipeline import apply_transform as j_apply
    from tdgs_torch.models import gaussians as tg
    from tdgs_torch.pipeline import apply_transform

    rng = np.random.default_rng(702)
    n = 40
    splats = {"means": rng.normal(size=(n, 3)), "quats": rng.normal(size=(n, 4)),
              "scales": rng.normal(size=(n, 3)) - 3, "opacities": rng.normal(size=(n,)),
              "sh0": rng.normal(size=(n, 1, 3)), "shN": rng.normal(size=(n, 15, 3))}
    splats = {k: v.astype(np.float32) for k, v in splats.items()}
    t = rng.normal(size=3).astype(np.float32)
    q = rng.normal(size=4).astype(np.float32)
    idx = np.arange(3, 30, 2) if subset else None
    center = np.array([0.1, -0.2, 0.3], np.float32) if subset else None
    want = j_apply({k: jnp.asarray(v) for k, v in splats.items()}, jnp.asarray(t),
                   jnp.asarray(q), None if idx is None else jnp.asarray(idx),
                   None if center is None else jnp.asarray(center))
    got = apply_transform(convert.splats_from_numpy(splats, device="cpu"),
                          torch.from_numpy(t), torch.from_numpy(q),
                          None if idx is None else torch.from_numpy(idx),
                          None if center is None else torch.from_numpy(center))
    for k in ("means", "quats"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6,
                                   err_msg=k)
    for g, w in zip(tg.splat_activations(got), jg.splat_activations(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    np.testing.assert_allclose(tg.rgb_to_sh(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jg.rgb_to_sh(jnp.asarray(rgb))), atol=1e-6)
    np.testing.assert_allclose(tg.sh_to_rgb(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jg.sh_to_rgb(jnp.asarray(rgb))), atol=1e-6)
    assert tg.num_sh_coeffs(3) == jg.num_sh_coeffs(3) == 16
