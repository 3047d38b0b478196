"""The UT projection's forward-only function (``ops/projection_ut.py``
``project_ut_for_tiles``) and who calls it, on the CPU and on the card.

On the CPU the function takes the differentiable chain
(``fully_fused_projection_with_ut``) under ``torch.no_grad()``: its outputs
must equal the chain's bit for bit and carry no gradient, over every camera
model, distortion set, rolling shutter and option the kernel covers
(``CASES``). ``rendering.rasterization`` must route an eval3d ``classic``
render of colours alone through it, and keep the chain where a gradient
flows through an output: an ``antialiased`` render (the compensations scale
the opacities), a render with a depth channel (the depths become colours),
a screen-space render with ``with_ut``. The function refuses
``calc_compensations``. A 3DGUT ``Runner`` step with the monocular-normal
loss keeps that loss's gradient through the gaussians' centres.

On the card (marked ``cuda``; the file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed)

    python -m pytest --noconftest -m cuda tests/test_torch_ut_project.py

the kernel (``csrc/ut_project.cu``) against the chain on the card over the
same cases with one camera and three, on ``card_scenes.ut_scene``'s rows
(behind the camera, at the near plane, off the image beyond its margin,
large, degenerate), at 1M rows at 1236x822, with batch dimensions and
unaligned rows, one launch a call, and the wrapper refusing what it does
not take. The tolerances are ``_assert_matches_chain``'s.
"""

import os

import numpy as np
import pytest
import torch

import tdgs_torch
from tdgs_torch import rendering
from tdgs_torch.ops import _build
from tdgs_torch.ops.camera_models import FThetaCameraDistortionParameters, RollingShutterType
from tdgs_torch.ops.projection import ALPHA_THRESHOLD
from tdgs_torch.ops.projection_ut import (
    KERNEL,
    UnscentedTransformParameters,
    fully_fused_projection_with_ut,
    project_ut_for_tiles,
)
from tests import card_scenes as C

DISTORTED = ("radial", "tangential", "thin_prism")
FTHETA = FThetaCameraDistortionParameters(
    angle_to_pixeldist_poly=(0.0, 800.0, 2.0, -40.0, 1.0, 0.0), max_angle=1.2)
ORTHO_FOCAL = 60.0  # pixels a world unit: the regular rows' ±10 units fill the image

# name → the projection's options beyond the scene's: ``dist``, the
# distortion terms (``card_scenes.ut_distortion``); ``rs``, a rolling
# shutter whose end pose is ``card_scenes.rolling_shutter_kw``'s
CASES = {
    "pinhole": {},
    "pinhole_radial": dict(dist=("radial",)),
    "pinhole_distorted": dict(dist=DISTORTED),
    "pinhole_tangential_prism": dict(dist=("tangential", "thin_prism")),
    "fisheye": dict(camera_model="fisheye"),
    "fisheye_radial": dict(camera_model="fisheye", dist=("radial",)),
    "ftheta_default": dict(camera_model="ftheta"),
    "ftheta_poly": dict(camera_model="ftheta", ftheta_coeffs=FTHETA),
    "ortho": dict(camera_model="ortho"),
    "rs_top_to_bottom_distorted": dict(dist=DISTORTED, rs=RollingShutterType.TOP_TO_BOTTOM),
    "rs_right_to_left_3_passes": dict(rs=RollingShutterType.RIGHT_TO_LEFT, rs_iterations=3),
    "all_sigma_points_valid": dict(
        ut_params=UnscentedTransformParameters(require_all_sigma_points_valid=True)),
    "no_opacities": dict(opacities=None),
    "ut_weights_margin": dict(ut_params=UnscentedTransformParameters(
        alpha=0.8, beta=1.0, kappa=0.5, in_image_margin_factor=0.3)),
    "eps2d_zero_clip_planes": dict(eps2d=0.0, radius_clip=2.0, near_plane=0.02,
                                   far_plane=9.0),
}


def case_args(sc, name):
    """The projection's positional and keyword arguments for ``CASES[name]``
    on the scene ``sc`` (``card_scenes.ut_scene``)."""
    kw = dict(CASES[name])
    dist, rs = kw.pop("dist", ()), kw.pop("rs", None)
    n_cams, dev = sc["viewmats"].shape[0], sc["means"].device
    Ks = sc["Ks"]
    if kw.get("camera_model") == "ortho":
        Ks = Ks.clone()
        Ks[:, 0, 0] = Ks[:, 1, 1] = ORTHO_FOCAL
    if dist:
        kw.update(C.ut_distortion(n_cams, dist, fisheye=kw.get("camera_model") == "fisheye",
                                  device=dev))
    if rs is not None:
        kw.update(rolling_shutter=rs, viewmats_rs=C.rolling_shutter_kw(sc)["viewmats_rs"])
    opacities = kw.pop("opacities", sc["opacities"])
    return (sc["means"], sc["quats"], sc["scales"], opacities, sc["viewmats"], Ks,
            C.UT_WIDTH, C.UT_HEIGHT), kw


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_cpu_route_is_the_chain_bitwise(name):
    """The plain chain's outputs bit for bit, with no gradient though the
    inputs ask for one, and no launch counted."""
    sc = C.ut_scene(2000, n_cams=2, seed=len(name))
    for k in ("means", "quats", "scales", "opacities"):
        sc[k] = sc[k].requires_grad_(True)
    args, kw = case_args(sc, name)
    n0 = _build.LAUNCHES.get(KERNEL, 0)
    got = project_ut_for_tiles(*args, **kw)
    want = fully_fused_projection_with_ut(*args, **kw)
    assert _build.LAUNCHES.get(KERNEL, 0) == n0
    assert want[1].requires_grad  # the chain differentiates its inputs
    assert got[4] is None and want[4] is None
    for g, w in zip(got, want):
        if w is not None:
            assert not g.requires_grad and g.grad_fn is None
            assert g.dtype == w.dtype and torch.equal(g, w.detach())
    radii = want[0]
    assert bool((radii > 0).any()) and bool((radii == 0).any())  # both sides of the tests


SMALL = 96, 64  # the routing tests' image: the scene's camera scaled down


def _small_scene(n=300):
    sc = C.ut_scene(n, seed=4)
    s = SMALL[0] / C.UT_WIDTH
    sc["Ks"] = sc["Ks"] * torch.tensor([s, s, 1.0])[:, None]
    sc["colors"] = torch.rand((n, 3), generator=torch.Generator().manual_seed(5))
    return sc


def _spy(monkeypatch):
    """Record each projection ``rendering`` calls: (name, outputs)."""
    calls = []
    for name in ("project_ut_for_tiles", "fully_fused_projection_with_ut"):
        def spy(*a, _fn=getattr(rendering, name), _name=name, **k):
            out = _fn(*a, **k)
            calls.append((_name, out))
            return out
        monkeypatch.setattr(rendering, name, spy)
    return calls


# name → (rasterization options, the projection it must take)
ROUTES = {
    "eval3d_packed_rgb": (dict(with_eval3d=True), "project_ut_for_tiles"),
    "eval3d_dense_rgb": (dict(with_eval3d=True, rasterizer="eval3d"), "project_ut_for_tiles"),
    "eval3d_antialiased": (dict(with_eval3d=True, rasterize_mode="antialiased"),
                           "fully_fused_projection_with_ut"),
    "eval3d_rgb_ed": (dict(with_eval3d=True, render_mode="RGB+ED"),
                      "fully_fused_projection_with_ut"),
    "screen_space_ut": (dict(rasterizer="packed"), "fully_fused_projection_with_ut"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_rasterization_takes_the_tile_only_projection_where_no_gradient_flows(
        monkeypatch, route):
    """One projection a render, the one its options call for. Through the
    tile-only function nothing of the projection carries a gradient and the
    means still get theirs (along the rays); through the chain the output
    that reaches the loss does: the compensations under ``antialiased``,
    the depths under "RGB+ED", and each depends on the means."""
    opts, want = ROUTES[route]
    sc = _small_scene()
    means = sc["means"].clone().requires_grad_(True)
    calls = _spy(monkeypatch)
    img, alpha, _ = tdgs_torch.rasterization(
        means, sc["quats"], sc["scales"], sc["opacities"], sc["colors"], sc["viewmats"],
        sc["Ks"], *SMALL, with_ut=True, device="cpu", **opts)
    assert [name for name, _ in calls] == [want]
    _, means2d, depths, _, comps = calls[0][1]
    loss = img.sum() + alpha.sum()
    if want == "project_ut_for_tiles":
        assert not means2d.requires_grad and not depths.requires_grad
        (g,) = torch.autograd.grad(loss, means)
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
        return
    carrier = {"eval3d_antialiased": comps, "eval3d_rgb_ed": depths}.get(route, means2d)
    (through,) = torch.autograd.grad(loss, carrier, retain_graph=True)
    assert bool((through != 0).any())
    (to_means,) = torch.autograd.grad(carrier.sum(), means)
    assert bool((to_means != 0).any())


def test_compensations_are_refused():
    """The tile-only function computes no compensations: a caller that
    scales its opacities by them takes the chain."""
    sc = C.ut_scene(64, seed=2)
    args, kw = case_args(sc, "pinhole")
    with pytest.raises(ValueError, match="calc_compensations"):
        project_ut_for_tiles(*args, calc_compensations=True, **kw)


def _normals_runner_step(root, result_dir):
    """One 3DGUT ``Runner`` step with the monocular-normal loss from step 0
    and no depth loss (a colour-only render): the Adam moments after it."""
    from tdgs_torch.strategy import MCMCStrategy
    from tdgs_torch.training.config import Config
    from tdgs_torch.training.trainer import Runner

    cfg = Config(data_dir=root, result_dir=result_dir, data_factor=1, max_steps=1,
                 eval_steps=[], save_steps=[], sh_degree=1, sh_degree_interval=1,
                 tile_capacity=256, test_every=4, tb_every=1, with_ut=True, with_eval3d=True,
                 load_normals=True, start_normal_loss_step=0, init_opa=0.5, init_scale=0.1,
                 seed=3, strategy=MCMCStrategy(cap_max=512, refine_start_iter=100))
    runner = Runner(cfg, device="cpu")
    try:
        hist = runner.train()["history"]
        return hist[0]["loss"], {k: v.clone() for k, v in runner.opt_state["mu"].items()}
    finally:
        runner.close()


def test_3dgut_normal_loss_gradient_reaches_the_centres(tmp_path, monkeypatch):
    """Under 3DGUT the normal loss samples the normal maps at the gaussians'
    centres and sends its gradient back through them (the JAX package's
    step does). The colour-only eval3d render projects through the
    tile-only function, whose centres carry no gradient, so the trainer
    projects them again through the chain: the step's Adam moments equal,
    within 1e-5 of each group's largest (the gradients' terms summed in
    another order), those of the step whose render projects through the
    chain itself, and they differ in the means from the step whose samples
    take detached centres."""
    from tdgs_torch.training import normal_losses as NL
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path / "scene")
    make_colmap_test_scene(root, device="cpu")
    gen = torch.Generator().manual_seed(0)
    os.makedirs(os.path.join(root, "normals"))
    for name in sorted(os.listdir(os.path.join(root, "images"))):
        n = torch.randn((48, 64, 3), generator=gen)
        np.save(os.path.join(root, "normals", f"{os.path.splitext(name)[0]}.npy"),
                (n / n.norm(dim=-1, keepdim=True)).numpy())
    loss, got = _normals_runner_step(root, str(tmp_path / "tiles"))

    with monkeypatch.context() as m:
        m.setattr(rendering, "project_ut_for_tiles", fully_fused_projection_with_ut)
        loss_chain, want = _normals_runner_step(root, str(tmp_path / "chain"))
    with monkeypatch.context() as m:
        sample = NL.sample_normals_from_map
        m.setattr(NL, "sample_normals_from_map", lambda maps, m2d: sample(maps, m2d.detach()))
        _, detached = _normals_runner_step(root, str(tmp_path / "detached"))

    assert loss == loss_chain
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= 1e-5 * float(w.abs().max()), k
    lost = float((detached["means"] - want["means"]).abs().max())
    assert lost > 1e-2 * float(want["means"].abs().max()), lost


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

MEANS2D_TOL = 1e-3  # pixels
DEPTH_RTOL = 1e-6
CONIC_RTOL = 2e-4
RADII_SHARE = 1e-4
RADIUS_RTOL = 1e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _real_radii(conics, opacities):
    """extend·sqrt(c00 + eps2d), extend·sqrt(c11 + eps2d) in float64, the
    covariance taken back from the conic (its inverse)."""
    a, b, c = conics.double().unbind(-1)
    det = a * c - b * b
    extend = torch.full_like(a, 3.33)
    if opacities is not None:
        op = opacities.double().expand_as(a)
        extend = torch.minimum(extend, torch.sqrt(2.0 * torch.log(
            torch.clamp(op, min=ALPHA_THRESHOLD) / ALPHA_THRESHOLD)))
    return torch.stack([extend * torch.sqrt(c / det), extend * torch.sqrt(a / det)], -1)


def _assert_radii(got, want, args, kw):
    """Equal but on at most ``RADII_SHARE`` of the rows, each where the
    rounding up can go either way: the chain's extend·sqrt(c) within
    ``RADIUS_RTOL`` of an integer (the kernel's then differs by one pixel,
    or that pixel moved the footprint across a margin or ``radius_clip``),
    or the footprint's edge within ``MEANS2D_TOL`` of a margin. The
    covariances of the two computations differ by up to 6e-5 of their value
    (a camera-space coordinate near 0 is a difference of terms of the
    scene's size), so a radius within 3e-5 of an integer can round either
    way: ``RADIUS_RTOL`` is 1e-4."""
    radii, means2d = got[0], got[1]
    r0, m0, c0 = want[0], want[1], want[3]
    bad = (radii != r0).any(-1)
    rows = radii.shape[:-1].numel()
    detail = [(radii[i].tolist(), r0[i].tolist(), m0[i].tolist(), c0[i].tolist())
              for i in map(tuple, bad.nonzero()[:4].tolist())]
    assert int(bad.sum()) <= int(RADII_SHARE * rows), (int(bad.sum()), detail)
    if not bool(bad.any()):
        return
    ut = kw.get("ut_params", UnscentedTransformParameters())
    width, height = args[6], args[7]
    op = args[3]
    op = None if op is None else op[..., None, :].expand(bad.shape)[bad]
    real = _real_radii(c0[bad], op)
    near_int = ((real - real.round()).abs() <= RADIUS_RTOL * real).any(-1)
    mine = (radii[bad] > 0).any(-1)[:, None]
    r = torch.where(mine, radii[bad], r0[bad]).double()
    m = torch.where(mine, means2d[bad], m0[bad]).double()
    mx, my = ut.in_image_margin_factor * width, ut.in_image_margin_factor * height
    edges = torch.stack([m[:, 0] + r[:, 0] + mx, m[:, 0] - r[:, 0] - width - mx,
                         m[:, 1] + r[:, 1] + my, m[:, 1] - r[:, 1] - height - my], -1)
    at_margin = (edges.abs() <= MEANS2D_TOL).any(-1)
    both = (radii[bad] > 0).any(-1) & (r0[bad] > 0).any(-1)
    one_pixel = ((radii[bad] - r0[bad]).abs() <= 1).all(-1)
    ok = near_int & (one_pixel | ~both) | at_margin & ~both
    assert bool(ok.all()), (detail, real.tolist())


def _assert_matches_chain(got, want, args, kw):
    """The kernel's outputs against the plain chain's on the card:

    - means2d within 1e-3 px, or 8 float32 ulps of the value beyond 2048 px
      (where 1e-3 is less than 4): the 7 pixels are summed in another order
      and with fused multiply-adds, a few ulps apart (rows at the near
      plane seen from a turned or moving camera land 15,000 px out);
    - depths within 1e-6 of the magnitude of the dot product they are
      (Σ|R₂ⱼ μⱼ| + |t₂|): the same three products summed in another order;
    - each conic within 2e-4 of its own size (|a| + |c|) of the float64
      chain's, over the rows both keep (the others' conics are never read,
      and a determinant near 0 makes them huge): a small gaussian's seven
      pixels spread over a few pixels, where float32 keeps a pixel near
      1,200 px to 1.2e-4, so the float32 chain itself lies up to 1.44e-4 of
      that size from float64, and the kernel up to 1.21e-4 (every case
      here, C = 1 and 3, and the 1M rows);
    - radii by ``_assert_radii``."""
    radii, means2d, depths, conics, _ = got
    r0, m0, d0, c0, _ = want
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous()
        assert not g.requires_grad
    means, viewmats = args[0], args[4]
    room = torch.clamp(8 * _spacing(m0), min=MEANS2D_TOL)
    off = (means2d - m0).abs() / room
    assert bool((off <= 1).all()), (float(off.max()), m0.reshape(-1, 2)[
        off.reshape(-1, 2).amax(-1).argmax()].tolist())
    R, t = viewmats[..., 2, :3].double(), viewmats[..., 2, 3].double()
    scale = (torch.einsum("...cj,...nj->...cn", R.abs(), means.double().abs())
             + t.abs()[..., None])
    off = (depths.double() - d0.double()).abs() / (DEPTH_RTOL * scale)
    assert bool((off <= 1).all()), float(off.max())
    kept = (r0 > 0).any(-1) & (radii > 0).any(-1)
    assert bool(kept.any())
    c64 = fully_fused_projection_with_ut(
        *(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args),
        **{k: v.double() if torch.is_tensor(v) else v for k, v in kw.items()})[3][kept]
    size = c64[:, 0].abs() + c64[:, 2].abs()
    off = (conics[kept].double() - c64).abs().amax(-1) / (CONIC_RTOL * size)
    worst = int(off.argmax())
    assert bool((off <= 1).all()), (float(off[worst]), c64[worst].tolist(),
                                    conics[kept][worst].tolist())
    _assert_radii(got, want, args, kw)


def _spacing(x):
    """The float32 ulp at each |x|."""
    return torch.nextafter(x.abs(), torch.full_like(x, float("inf"))) - x.abs()


def _one_launch(args, kw):
    n0 = _build.LAUNCHES.get(KERNEL, 0)
    got = project_ut_for_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[KERNEL] == n0 + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_cams", [1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_the_chain_on_card(card, name, n_cams):
    sc = C.ut_scene(20_000, n_cams=n_cams, seed=n_cams + 10 * len(name), device=card)
    args, kw = case_args(sc, name)
    got = _one_launch(args, kw)
    _assert_matches_chain(got, fully_fused_projection_with_ut(*args, **kw), args, kw)
    if kw.get("camera_model", "pinhole") == "pinhole":  # the first camera drops those groups
        kept = (got[0][0] > 0).any(-1)
        assert not bool(kept[sc["group"] == C.UT_GROUPS.index("behind")].any())
        assert not bool(kept[sc["group"] == C.UT_GROUPS.index("off_image")].any())


@pytest.mark.cuda
def test_kernel_at_full_size_on_card(card):
    """The 3DGUT cell's shape: 1M gaussians, one 1236x822 pinhole camera,
    global shutter."""
    sc = C.ut_scene(1_000_000, seed=7, device=card)
    args, kw = case_args(sc, "pinhole")
    got = _one_launch(args, kw)
    _assert_matches_chain(got, fully_fused_projection_with_ut(*args, **kw), args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pinhole", "rs_top_to_bottom_distorted"])
def test_kernel_batches_and_unaligned_rows_on_card(card, name):
    """Batch dimensions [2, C, N] (a row's camera and gaussian from its
    batch entry), and rows one row into larger arrays with N not a
    multiple of the block, the quaternions one float into theirs (off a
    16-byte boundary: the scalar loads)."""
    sc = C.ut_scene(5001, n_cams=2, seed=3, device=card)
    args, kw = case_args(sc, name)
    shifted = [a[1:] if i < 4 else a for i, a in enumerate(args)]
    quats = torch.empty(shifted[1].numel() + 1, device=card)[1:].view(shifted[1].shape)
    shifted[1] = quats.copy_(shifted[1])
    shifted = tuple(shifted)
    assert shifted[1].data_ptr() % 16 != 0 and shifted[1].is_contiguous()
    _assert_matches_chain(_one_launch(shifted, kw),
                          fully_fused_projection_with_ut(*shifted, **kw), shifted, kw)
    other = C.ut_scene(5000, n_cams=2, seed=4, device=card)
    rows = ("means", "quats", "scales", "opacities")
    # the second entry: other gaussians, the cameras in the other order
    batched = tuple([torch.stack([a[:5000], other[rows[i]]]) for i, a in enumerate(args[:4])]
                    + [torch.stack([a, a.flip(0)]) for a in args[4:6]] + list(args[6:]))
    kw_b = {k: torch.stack([v, v.flip(0)]) if torch.is_tensor(v) else v
            for k, v in kw.items()}
    got = _one_launch(tuple(batched), kw_b)
    assert got[0].shape == (2, 2, 5000, 2)
    _assert_matches_chain(got, fully_fused_projection_with_ut(*batched, **kw_b), batched, kw_b)


@pytest.mark.cuda
def test_kernel_no_rows_on_card(card):
    sc = C.ut_scene(0, device=card)
    args, kw = case_args(sc, "pinhole")
    radii, means2d, depths, conics, comps = project_ut_for_tiles(*args, **kw)
    assert radii.shape == (1, 0, 2) and conics.shape == (1, 0, 3) and comps is None


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs_on_card(card):
    sc = C.ut_scene(64, seed=14, device=card)
    args, _ = case_args(sc, "pinhole")

    def with_(i, x):
        return tuple(x if j == i else a for j, a in enumerate(args))

    radial4 = torch.zeros((1, 4), device=card)
    bad = [
        (with_(0, args[0].double()), {}, "float32"),
        (with_(3, args[3].double()), {}, "float32"),
        (with_(1, args[1].t().contiguous().t()), {}, "contiguous"),
        (with_(2, torch.zeros(64, 6, device=card)[:, ::2]), {}, "contiguous"),
        (with_(2, args[2].cpu()), {}, "device"),
        (with_(4, args[4].cpu()), {}, "device"),
        (with_(3, args[3][:-1]), {}, "shape"),
        (with_(4, args[4][None]), {}, "shape"),
        (args, dict(radial_coeffs=radial4), "shape"),
        (args, dict(camera_model="spherical"), "camera model"),
    ]
    for a, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            project_ut_for_tiles(*a, **kw)
