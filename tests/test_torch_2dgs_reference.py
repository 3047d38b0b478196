"""The port's 2DGS path against the benchmark's plain reference
(``portbench/reference/render_2dgs.py``, plain PyTorch written from the
paper) on seeded surfels of the benchmark's state generator at a small
size, on the CPU (the kernels' plain versions):

- the forward colour, alpha, expected depth, rendered normals, the depth
  map's normals and the distortion;
- the gradients of means, quats, scales, opacities and the SH colours
  through every one of those outputs;
- the reference's distortion against the paper's double sum
  Σ_ij w_i w_j |z_i − z_j| on random inputs;
- one 2DGS ``Runner`` step past the DefaultStrategy's stop through the
  benchmark's driver at a size a CPU holds: its losses, the gradient Adam
  received and the change;
- ``footprint_plan`` of the surfel projection's radii against the 2DGS
  stream's demand, with the EWA and UT plans as before;
- the tiles' cut counted in ``n_dropped`` on the 2DGS path;
- the reference with the ray transform read transposed, in bfloat16,
  without the distortion term, without the normal term or with the loss
  over half the image's rows fails.

Tolerances: the same float32 arithmetic in another order of operations.
Colour and alpha 1e-5 absolute (read: 5.7e-7); depth, distortion and
normals 1e-4 absolute (read: 2.2e-5; the expected depth and the depth
map's normals divide by the alpha and by pixel-sized differences of
depths near 5); gradients 1e-4 of each group's largest; the Runner step's
loss gap 1e-4 (read: 3.7e-7), its gradient and change gaps 2e-4 (read:
1.2e-6 over the rows the driver compares, 4.2e-6: three steps of Adam,
whose step is a ratio of small moments). A wrong reference departs by
more than ten times its comparison's tolerance, or reads not correct in
the Runner step.
"""

import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tdgs_torch
from portbench.reference import render_2dgs as R2
from portbench.scenes import rich
from portbench.scenes.surfels import trained_surfels
from tdgs_torch.ops import tiling

SPEC = {"surface_jitter": 0.2, "log_scale_sd": 0.35, "flatness": 0.3, "big_share": 0.05,
        "big_mult": 2.5, "dead_share": 0.0, "shn_sd": 0.05, "normal_sd_deg": 3.0}
W, H = 48, 32
IMG_ATOL = 1e-5
GEOM_ATOL = 1e-4
GRAD_RTOL = 1e-4
CASES = [(20, 1, 1), (300, 3, 6), (2000, 4, 2)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(n, seed, view):
    st = trained_surfels(n, seed, "cpu", SPEC)
    vms, K = rich.cameras(8, W, H)
    return st, torch.as_tensor(vms[view]), torch.as_tensor(K)


def _act(p):
    return (p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]),
            torch.cat([p["sh0"], p["shN"]], 1))


def _port(p, vm, K, tile_capacity=4096, isect_exact=True):
    """The port's training render → dict in the reference's names, the
    normals in the camera frame."""
    img, alpha, nrm, nfd, dist, _, meta = tdgs_torch.rasterization_2dgs(
        *_act(p), vm[None], K[None], W, H, sh_degree=3, render_mode="RGB+ED", distloss=True,
        rasterizer="packed", isect_exact=isect_exact, tile_capacity=tile_capacity,
        device="cpu")
    R = vm[:3, :3]
    return {"rgb": img[0, ..., :3], "alpha": alpha[0, ..., 0], "depth": img[0, ..., 3],
            "normals": nrm[0] @ R.T, "depth_normals": nfd[0] @ R.T, "dist": dist[0, ..., 0],
            "meta": meta}


@pytest.mark.parametrize("n,seed,view", CASES)
def test_forward_outputs(n, seed, view):
    st, vm, K = _scene(n, seed, view)
    got = _port(st, vm, K)
    want = R2.render(*_act(st), vm, K, W, H)
    assert want["live_pairs"] > 0 and want["entries"] == got["meta"]["n_isects"]
    assert got["meta"]["n_dropped"] == 0
    for k in ("rgb", "alpha"):
        assert float((got[k] - want[k]).abs().max()) < IMG_ATOL, k
    for k in ("depth", "normals", "depth_normals", "dist"):
        assert float(want[k].abs().max()) > 0, k
        assert float((got[k] - want[k]).abs().max()) < GEOM_ATOL, k


def _weights(seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(shape, generator=g) for k, shape in
            (("rgb", (H, W, 3)), ("depth", (H, W)), ("normals", (H, W, 3)),
             ("depth_normals", (H, W, 3)), ("dist", (H, W)))}


@pytest.mark.parametrize("n,seed,view", CASES)
def test_gradients(n, seed, view):
    st, vm, K = _scene(n, seed, view)
    w = _weights(seed)
    leaves = {k: v.clone().requires_grad_(True) for k, v in st.items()}
    got = _port(leaves, vm, K)
    sum(((got[k] * w[k]).sum() for k in w), torch.zeros(())).backward()

    def of_images(rgb, alpha, depth, normals, depth_normals, dist):
        out = dict(rgb=rgb, depth=depth, normals=normals, depth_normals=depth_normals,
                   dist=dist)
        return sum((out[k] * w[k]).sum() for k in w)

    _, grads, info = R2.render_backward(st, vm, K, W, H, of_images)
    assert int(info["visible"].sum()) > 0
    for k in ("means", "quats", "scales", "opacities", "sh0", "shN"):
        want, have = grads[k], leaves[k].grad
        scale = float(want.abs().max())
        assert scale > 0, k
        assert float((have - want).abs().max()) <= GRAD_RTOL * scale, k
    # the third scale is not read: no gradient reaches it
    assert float(leaves["scales"].grad[:, 2].abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_distortion_is_the_papers_double_sum(seed):
    """Σ_i Σ_j w_i w_j |z_i − z_j| over every pair, in float64, against the
    reference's running sums in depth order; entries in any order."""
    g = torch.Generator().manual_seed(seed)
    n, P, L = 3, 5, 40
    w = torch.rand((n, P, L), generator=g, dtype=torch.float64) / L
    z = 1.0 + 9.0 * torch.rand((n, L), generator=g, dtype=torch.float64)
    want = (w[..., :, None] * w[..., None, :]
            * (z[:, None, :, None] - z[:, None, None, :]).abs()).sum((-1, -2))
    got = R2.distortion(w, z)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("variant", ["transposed", "bfloat16"])
def test_wrong_render_departs(variant):
    """The ray transform read transposed, or the composite in bfloat16,
    departs from the port well past the forward's tolerance at every case."""
    kw = {"transposed": True} if variant == "transposed" else {"dtype": torch.bfloat16}
    for n, seed, view in CASES:
        st, vm, K = _scene(n, seed, view)
        got = _port(st, vm, K)
        want = R2.render(*_act(st), vm, K, W, H, **kw)
        assert float((got["rgb"] - want["rgb"]).abs().max()) > 10 * IMG_ATOL, (variant, n)


def _cell(width=64, height=48, n_gauss=3000):
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "portbench")

    def load(*parts):
        with open(os.path.join(here, *parts)) as fd:
            return json.load(fd)

    cfg = load("configs", "garden_2dgs.json")
    cfg["scene"].update(n_gt=3000, sfm_points=300, n_images=8, width=width, height=height)
    cfg["state"]["n_gauss"] = n_gauss
    traffic = dict(load("traffic", "train_2dgs_steady.json"), period=2, warm_steps=2)
    return SimpleNamespace(name="tiny.train", chips=1, config=cfg, traffic=traffic,
                           limits=load("workloads", "garden_2dgs.train.json")["limits"])


SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def cell_cache(tmp_path_factory):
    from portbench import harness

    old = harness.CACHE
    harness.CACHE = str(tmp_path_factory.mktemp("cache"))
    yield
    harness.CACHE = old


def test_runner_step_against_the_reference(cell_cache):
    """The driver's checked steps on the system's CPU path: Runner.train
    with the 2DGS render, both terms and the DefaultStrategy past its stop,
    three chained steps and one more, against the reference's from the
    same state and images."""
    from portbench.drivers import train_2dgs

    out = train_2dgs.run(_cell(), SEED, 0.0, False, "cpu", 0.0)
    v = out["values"]
    assert out["correct"] and out["failed"] == 0, out["compared"]
    assert v["loss_gap"] < 1e-4 and v["grad_gap"] < 2e-4, v
    assert v["change_gap"] < 2e-4, v
    assert out["ctx"]["plan"]["full_isect_demand"] > 0


@pytest.mark.parametrize("fault", ["", "half", "transposed", "no_dist", "no_normal"])
def test_control_and_faults_are_not_correct(cell_cache, fault):
    """The bfloat16 control ("") and each planted fault in the system's
    place read not correct against the cell's limits."""
    from portbench.drivers import train_2dgs

    out = train_2dgs.run(_cell(), SEED, 0.0, False, "cpu", 0.0, control=True, fault=fault)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("n,seed,view", CASES[1:])
def test_derive_isect_plan_with_2dgs(n, seed, view):
    """The plan of the surfel projection's footprints sizes the 2DGS
    stream; ``derive_isect_plan``'s EWA and UT plans are that plan of their
    own projections' footprints, as before."""
    from tdgs_torch.ops.projection import fully_fused_projection
    from tdgs_torch.ops.projection_2dgs import fully_fused_projection_2dgs

    st, vm, K = _scene(n, seed, view)
    means, quats, scales, op, sh = _act(st)
    radii, means2d, _, _, _ = fully_fused_projection_2dgs(means, quats, scales, vm[None],
                                                          K[None], W, H)
    plan = tiling.footprint_plan(means2d, radii, W, H, max_tiles_per_gauss=64)
    assert plan["full_isect_demand"] == _port(st, vm, K)["meta"]["n_isects"] > 0
    args = (means, quats, scales, op, vm[None], K[None], W, H)
    ewa = tiling.derive_isect_plan(*args, max_tiles_per_gauss=64, device="cpu")
    radii, means2d, _, _, _ = fully_fused_projection(means, quats, scales, vm[None], K[None],
                                                     W, H, opacities=op)
    assert tiling.footprint_plan(means2d, radii, W, H, max_tiles_per_gauss=64) == ewa
    _, _, ewa_meta = tdgs_torch.rasterization(means, quats, scales, op, sh, vm[None], K[None],
                                              W, H, sh_degree=3, rasterizer="packed",
                                              isect_exact=True, device="cpu")
    assert ewa["full_isect_demand"] == ewa_meta["n_isects"] != plan["full_isect_demand"]
    ut = tiling.derive_isect_plan(*args, max_tiles_per_gauss=64, device="cpu", with_ut=True)
    _, _, ut_meta = tdgs_torch.rasterization(means, quats, scales, op, sh, vm[None], K[None],
                                             W, H, sh_degree=3, with_ut=True, with_eval3d=True,
                                             isect_exact=True, tile_capacity=4096,
                                             device="cpu")
    assert ut["full_isect_demand"] == ut_meta["n_isects"]


@pytest.mark.parametrize("isect_exact", [True, False])
def test_tile_cut_counts_in_n_dropped(isect_exact):
    """A tile capacity below the fullest tile: on the ``"packed"`` path
    every entry past a tile's kept 128 counts in ``n_dropped``; at a
    capacity above the fullest tile nothing does."""
    st, vm, K = _scene(2000, 4, 2)
    meta = _port(st, vm, K, tile_capacity=128, isect_exact=isect_exact)["meta"]
    off = meta["isect_offsets"]
    cut = int(torch.clamp(off[1:] - off[:-1] - 128, min=0).sum())
    assert cut > 0 and meta["n_dropped"] == cut
    full = _port(st, vm, K, isect_exact=isect_exact)["meta"]
    assert full["n_dropped"] == 0


def test_surfels_lie_in_their_surfaces():
    """The benchmark's surfel state: each rotation's third axis is the
    normal of the surface its mean was drawn on, tilted by the spec's
    gaussian angle a tangent axis (rms √2 of it), and the rest of the state
    is the 3DGS generator's."""
    from portbench.reference.render import quat_rotmat
    from portbench.scenes.state import trained_state
    from portbench.scenes.surfels import surface_normals

    spec = dict(SPEC, surface_jitter=0.0, normal_sd_deg=0.0)
    st = trained_surfels(4000, 5, "cpu", spec)
    base = trained_state(4000, 5, "cpu", spec)
    for k in base:
        if k != "quats":
            assert torch.equal(st[k], base[k]), k
    normals = surface_normals(st["means"].numpy().astype(np.float64), rich.Surfaces())
    axis = quat_rotmat(st["quats"])[..., 2].double().numpy()
    np.testing.assert_allclose(np.abs((axis * normals).sum(-1)), 1.0, atol=1e-5)
    tilted = quat_rotmat(trained_surfels(4000, 5, "cpu", dict(spec, normal_sd_deg=3.0))[
        "quats"])[..., 2].double().numpy()
    angle = np.degrees(np.arccos(np.clip(np.abs((tilted * normals).sum(-1)), 0.0, 1.0)))
    assert 3.5 < float(np.sqrt((angle ** 2).mean())) < 5.0
    # the ground's normal is the terrain's: a step along the surface stays on it
    n_ground = int(4000 * 0.55)
    p = st["means"][:n_ground].double().numpy()
    t = np.cross(normals[:n_ground], [1.0, 0.0, 0.0])
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    q = p + 1e-3 * t
    z = rich.terrain_z(q[:, :2].astype(np.float32)).astype(np.float64)
    assert np.abs(q[:, 2] - z).max() < 1e-5
    assert math.isclose(float(np.linalg.norm(normals, axis=-1).max()), 1.0, rel_tol=1e-9)
