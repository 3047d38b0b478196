"""Port parity of the world-space (eval3d, 3DGUT) rasterizer: the plain
versions of kernels 7 and 8 behind
``tdgs_torch.ops.rasterize_eval3d_packed`` against the JAX package's
``rasterize_eval3d_pallas`` (Pallas in interpret mode on the CPU, as the
JAX package's own tests run it) over one shared stream (projection and
tiling from the JAX package), the whole ``rasterization(with_eval3d=True)``
against the JAX package's jnp ``"eval3d"`` path, and the reference's σ*
fault.

The JAX package evaluates σ* as the quadratic form ½(|g|² − (g·r)²/|r|²)
(rasterize_eval3d_pallas.py:216, :663; rasterize_eval3d.py:233); the port
takes ½|g × r|²/|r|². At these tests' scale (z ≈ 5, scales 0.04–0.11,
|g|² ≈ 1e4) the two agree to about 1e-3; at real scene scales the
quadratic form loses σ* (``test_reference_fault_sigma_cancellation``).

Tolerances, the JAX package's own for its eval3d paths
(tests/test_eval3d.py:305, :355): outputs 5e-3 absolute, gradients max|Δ|
≤ 3e-2 · max|ref| per input. Reached here: outputs within 1.2e-3 and
gradients within 1e-2 of the group's max (the rolling shutter's
quadratic form, oᵀAo − 2oᵀAμ + μᵀAμ, cancels the most).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops import tiling as jtiling
from tdgs.ops.camera_models import RollingShutterType as JRS
from tdgs.ops.projection import fully_fused_projection as j_project
from tdgs.ops.rasterize_eval3d_pallas import (
    _tile_rays_world as j_tile_rays,
    rasterize_to_pixels_eval3d_packed as j_packed,
)
from tdgs.rendering import rasterization as j_render
import tdgs_torch
from tdgs_torch.ops import _build
from tdgs_torch.ops import rasterize_eval3d_packed as E
from tdgs_torch.ops.camera_models import RollingShutterType
from tdgs_torch.ops.segment_sum import segment_rows_sum_plain, sort_ids
from tests.test_eval3d import K, make_scene
from tests.test_torch_rasterize_packed_grad import _carry_artefact_slots

ATOL = 5e-3
RTOL = 3e-2
NAMES = ("means", "quats", "scales", "colors", "opacities", "viewmats")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _end_pose(viewmats, shift):
    end = viewmats.copy()
    end[0, 0, 3] += shift
    return end


def _stream(seed, N=32, width=64, height=48, scale_rng=(-3.2, -2.2), spread=0.8):
    """A make_scene scene tiled by the JAX package (EWA projection,
    isect_tiles_packed): the stream both rasterizers read."""
    rng = np.random.default_rng(seed)
    means, quats, scales, opac, colors, viewmats = make_scene(
        rng, N=N, spread=spread, scale_rng=scale_rng)
    Ks = K.copy()
    Ks[0, 0, 2], Ks[0, 1, 2] = width / 2, height / 2
    radii, means2d, depths, _, _ = j_project(
        *map(jnp.asarray, (means, quats, scales, viewmats, Ks)), width, height)
    isect = jtiling.isect_tiles_packed(means2d, radii, depths, 16, -(-width // 16),
                                       -(-height // 16), max_tiles_per_gauss=16)
    return dict(means=means, quats=quats, scales=scales, colors=colors[None],
                opacities=opac[None], viewmats=viewmats, Ks=Ks, width=width,
                height=height, offsets=np.array(isect.offsets),
                flatten_ids=np.array(isect.flatten_ids), rng=rng)


def _cotangents(s):
    rng = np.random.default_rng(7)
    H, W = s["height"], s["width"]
    return (rng.normal(size=(1, H, W, 3)).astype(np.float32),
            rng.normal(size=(1, H, W, 1)).astype(np.float32))


def _jax_grads(s, cot, tile_capacity, rs=None, bg=None):
    kw = {} if rs is None else dict(rolling_shutter=JRS.TOP_TO_BOTTOM,
                                    viewmats_rs=jnp.asarray(rs))

    def loss(*xs):
        img, alp = j_packed(*xs, jnp.asarray(s["Ks"]), s["width"], s["height"], 16,
                            jnp.asarray(s["offsets"]), jnp.asarray(s["flatten_ids"]),
                            tile_capacity=tile_capacity,
                            backgrounds=None if bg is None else jnp.asarray(bg), **kw)
        return jnp.sum(img * cot[0]) + jnp.sum(alp * cot[1]), (img, alp)

    xs = [jnp.asarray(s[k]) for k in NAMES]
    grads, outs = jax.jit(jax.grad(loss, argnums=tuple(range(6)), has_aux=True))(*xs)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_grads(s, cot, tile_capacity, rs=None, bg=None):
    leaves = [torch.from_numpy(np.array(s[k])).requires_grad_(True) for k in NAMES]
    kw = {}
    if rs is not None:
        kw = dict(rolling_shutter=RollingShutterType.TOP_TO_BOTTOM,
                  viewmats_rs=torch.from_numpy(rs))
    img, alp = E.rasterize_to_pixels_eval3d_packed(
        *leaves, torch.from_numpy(s["Ks"]), s["width"], s["height"], 16,
        torch.from_numpy(s["offsets"]), torch.from_numpy(s["flatten_ids"]),
        tile_capacity=tile_capacity, backgrounds=None if bg is None else torch.from_numpy(bg),
        **kw)
    loss = (img * torch.from_numpy(cot[0])).sum() + (alp * torch.from_numpy(cot[1])).sum()
    return ([img.detach().numpy(), alp.detach().numpy()],
            [g.numpy() for g in torch.autograd.grad(loss, leaves)])


def _assert_grads_close(got, want, names, rtol=RTOL):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert scale > 0.0, name
        assert err <= rtol * scale, f"{name}: max|Δ| {err} > {rtol} · {scale}"


@pytest.mark.parametrize("case", ["central", "rolling_shutter"])
def test_plain_kernels_match_pallas(case):
    """Kernels 7 and 8 (plain) with the row gather and the ray generation
    behind autograd against the Pallas pair: colours and alphas with a
    background, then the gradients of the gaussians and of the start pose
    (the rays and the recentred rows both depend on it)."""
    s = _stream(217)
    rs = _end_pose(s["viewmats"], 0.2) if case == "rolling_shutter" else None
    bg = np.array([[0.3, 0.5, 0.7]], np.float32)
    cot = _cotangents(s)
    want_o, want_g = _jax_grads(s, cot, 256, rs, bg)
    before = dict(_build.LAUNCHES)
    got_o, got_g = _port_grads(s, cot, 256, rs, bg)
    assert _build.LAUNCHES == before  # the plain versions: no kernel on the CPU
    for name, g, w in zip(("colors", "alphas"), got_o, want_o):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=name)
    assert float(want_o[1].max()) > 0.5  # the scene covers pixels
    _assert_grads_close(got_g, want_g, NAMES)


def test_plain_truncation_matches_pallas_with_carry_artefact():
    """Large gaussians over a 32×32 image: every tile's range overflows
    tile_capacity = 128. The forwards agree. The port gives every kept
    entry its gradient; the JAX backward zeroes the kept entries of a
    truncated tile that share the next tile's first 128-entry chunk.
    Zeroing exactly those slots in the port's per-entry rows gives the JAX
    gradients; without it they differ."""
    tc = 128
    s = _stream(503, N=160, width=32, height=32, scale_rng=(-1.6, -1.0), spread=0.4)
    s["opacities"] = s["opacities"] * 0.15  # pixels still open at the cut
    counts = np.diff(s["offsets"])
    assert (counts[:-1] > tc).sum() >= 2
    cot = _cotangents(s)
    want_o, want_g = _jax_grads(s, cot, tc)

    leaves = [torch.from_numpy(np.array(s[k])).requires_grad_(True) for k in NAMES]
    means, quats, scales, colors, opac, viewmats = leaves
    d, o, o_ref = E.tile_rays_world(1, 2, 2, 16, 32, 32, viewmats, torch.from_numpy(s["Ks"]))
    feats = E.feature_rows(means, quats, scales, opac, colors, o_ref)
    offs, ids = torch.from_numpy(s["offsets"]), torch.from_numpy(s["flatten_ids"])
    rows = feats.detach()[ids.long()]
    geo = (rows, d.detach(), None, offs, 1, 3, 32, 32, 16)
    img, T, _ = E.rasterize_eval3d_fwd_plain(*geo, tc)
    np.testing.assert_allclose(img.numpy(), want_o[0], atol=ATOL)
    np.testing.assert_allclose(1.0 - T.numpy(), want_o[1][..., 0], atol=ATOL)
    v_rows, v_d, _ = E.rasterize_eval3d_bwd_plain(
        *geo, img, T, torch.from_numpy(cot[0]), -torch.from_numpy(cot[1])[..., 0], tc)
    slots = _carry_artefact_slots(s["offsets"], tc)
    assert len(slots) and float(v_rows[slots].abs().max()) > 0.0  # the artefact bites
    sids, perm = sort_ids(ids, offs[-1])

    def per_input(r):
        sums = segment_rows_sum_plain(r, perm, sids, feats.shape[0])
        return [g.numpy() for g in torch.autograd.grad([feats, d], leaves, [sums, v_d],
                                                       retain_graph=True)]

    emulated = v_rows.clone()
    emulated[slots] = 0.0
    _assert_grads_close(per_input(emulated), want_g, NAMES)
    exact = per_input(v_rows)
    assert max(np.abs(g - w).max() / np.abs(w).max()
               for g, w in zip(exact, want_g)) > RTOL
    # rows past each tile's cut and past offsets[-1] are zero
    o_ = s["offsets"]
    assert float(v_rows[int(o_[-1]):].abs().sum()) == 0.0
    for t in np.nonzero(np.diff(o_) > tc)[0]:
        assert float(v_rows[o_[t] + tc:o_[t + 1]].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["pinhole_distorted", "fisheye", "rolling_shutter"])
def test_tile_rays_match_jax(case):
    """tile_rays_world against the JAX package's _tile_rays_world: unit
    directions to 1e-5, origins to 1e-5 (none for a central camera)."""
    rng = np.random.default_rng(31)
    viewmats = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    viewmats[1, :3, 3] = [0.2, -0.1, 0.3]
    viewmats[1, :3, :3] = np.array([[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]], np.float32)
    Ks = np.repeat(K, 2, 0)
    kw, tkw = {}, {}
    if case == "pinhole_distorted":
        coeffs = dict(radial_coeffs=np.tile([[0.05, -0.01, 0.002, 0.01, 0, 0]], (2, 1)),
                      tangential_coeffs=np.tile([[0.004, -0.003]], (2, 1)),
                      thin_prism_coeffs=np.tile([[0.001, 0, -0.002, 0]], (2, 1)))
        kw = {k: jnp.asarray(v, jnp.float32) for k, v in coeffs.items()}
        tkw = {k: torch.tensor(v, dtype=torch.float32) for k, v in coeffs.items()}
        model = "pinhole"
    elif case == "fisheye":
        r = np.tile([[0.03, -0.01, 0.004, -0.001]], (2, 1)).astype(np.float32)
        kw, tkw, model = dict(radial_coeffs=jnp.asarray(r)), dict(radial_coeffs=torch.from_numpy(r)), "fisheye"
    else:
        end = viewmats.copy()
        end[:, :3, 3] += rng.normal(size=(2, 3)) * 0.1
        kw = dict(rolling_shutter=JRS.BOTTOM_TO_TOP, viewmats_rs=jnp.asarray(end))
        tkw = dict(rolling_shutter=RollingShutterType.BOTTOM_TO_TOP,
                   viewmats_rs=torch.from_numpy(end))
        model = "pinhole"
    args = (2, 6, 4, 16, 96, 64)
    rays = jax.jit(functools.partial(
        j_tile_rays, *args, camera_model=model, ftheta_coeffs=None,
        rolling_shutter=kw.pop("rolling_shutter", JRS.GLOBAL)))
    jd, jo, jref, _ = rays(jnp.asarray(viewmats), jnp.asarray(Ks),
                           radial_coeffs=kw.get("radial_coeffs"),
                           tangential_coeffs=kw.get("tangential_coeffs"),
                           thin_prism_coeffs=kw.get("thin_prism_coeffs"),
                           viewmats_rs=kw.get("viewmats_rs"))
    d, o, o_ref = E.tile_rays_world(*args, torch.from_numpy(viewmats), torch.from_numpy(Ks),
                                    model, **tkw)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_allclose(o_ref.numpy(), np.asarray(jref), atol=1e-5)
    if case == "rolling_shutter":
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
    else:
        assert o is None and float(np.abs(np.asarray(jo)).max()) == 0.0


def _scene_api(seed=216, N=32):
    rng = np.random.default_rng(seed)
    return make_scene(rng, N=N)


@pytest.mark.parametrize("mode", ["RGB", "D", "ED", "RGB+D", "RGB+ED"])
def test_rasterization_with_eval3d_render_modes(mode):
    """rasterization(with_eval3d=True) in every render mode, with a
    background, against the JAX package's jnp "eval3d" path (its own
    tiling; well-separated scene, large stream capacity)."""
    means, quats, scales, opac, colors, viewmats = _scene_api()
    bg = np.array([[0.2, 0.4, 0.6]], np.float32)
    common = dict(tile_capacity=256, max_tiles_per_gauss=16, isect_capacity=1 << 12,
                  render_mode=mode, backgrounds=bg)
    want = jax.jit(functools.partial(j_render, width=64, height=48, rasterizer="eval3d",
                                     **common))(
        *map(jnp.asarray, (means, quats, scales, opac, colors, viewmats, K)))
    got = tdgs_torch.rasterization(means, quats, scales, opac, colors, viewmats, K, 64, 48,
                                   with_eval3d=True, device="cpu", **common)
    D = {"RGB": 3, "D": 1, "ED": 1, "RGB+D": 4, "RGB+ED": 4}[mode]
    assert got[0].shape == (1, 48, 64, D) and got[1].shape == (1, 48, 64, 1)
    # accumulated depth (about 5 per unit alpha) scales the absolute error
    atol = 5 * ATOL if mode in ("D", "RGB+D") else ATOL
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=atol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL)
    assert float(got[1].max()) > 0.5


@pytest.mark.parametrize("case", ["central", "rolling_shutter"])
def test_rasterization_with_eval3d_grads_match_jax(case):
    """jax.grad through the JAX package's jnp eval3d path (UT tiling for
    the rolling shutter) against autograd through the port, for means,
    quats, scales, opacities, colours and the start pose."""
    means, quats, scales, opac, colors, viewmats = _scene_api(217, N=32)
    kw = dict(tile_capacity=256, max_tiles_per_gauss=16, isect_capacity=1 << 12)
    jkw, tkw = {}, {}
    if case == "rolling_shutter":
        end = _end_pose(viewmats, 0.2)
        jkw = dict(with_ut=True, rolling_shutter=JRS.TOP_TO_BOTTOM, viewmats_rs=jnp.asarray(end))
        tkw = dict(with_ut=True, rolling_shutter=RollingShutterType.TOP_TO_BOTTOM,
                   viewmats_rs=torch.from_numpy(end))
    names = ("means", "quats", "scales", "opacities", "colors", "viewmats")
    inputs = (means, quats, scales, opac, colors, viewmats)

    def j_loss(*xs):
        img, alp, _ = j_render(*xs, jnp.asarray(K), 64, 48, rasterizer="eval3d", **kw, **jkw)
        return jnp.sum(img ** 2) + 0.3 * jnp.sum(alp ** 2)

    want = jax.jit(jax.grad(j_loss, argnums=tuple(range(6))))(*map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in inputs]
    img, alp, _ = tdgs_torch.rasterization(*leaves, torch.from_numpy(K), 64, 48,
                                           with_eval3d=True, device="cpu", **kw, **tkw)
    got = torch.autograd.grad((img ** 2).sum() + 0.3 * (alp ** 2).sum(), leaves)
    _assert_grads_close([g.numpy() for g in got], [np.asarray(w) for w in want], names)


def _sigma_f64(means, quats, scales, pixels, K_):
    """σ* of every gaussian along every pixel's ray, in float64 from the
    float32 inputs (identity camera): [P, N]."""
    q = quats.astype(np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                 -1).reshape(-1, 3, 3)
    M = np.swapaxes(R, 1, 2) / scales.astype(np.float64)[:, :, None]
    d = np.stack([(pixels[:, 0] - K_[0, 2]) / K_[0, 0], (pixels[:, 1] - K_[1, 2]) / K_[1, 1],
                  np.ones(len(pixels))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    g = -np.einsum("nij,nj->ni", M, means.astype(np.float64))  # [N, 3]
    r = np.einsum("nij,pj->pni", M, d)  # [P, N, 3]
    c = np.cross(g[None], r)
    sig = 0.5 * (c * c).sum(-1) / (r * r).sum(-1)
    return np.where((g[None] * r).sum(-1) < 0, sig, np.inf)


def test_reference_fault_sigma_cancellation():
    """Three gaussians at the bench scene's magnitudes (z ≈ 8, off axis,
    scales 0.005–0.03, focal 1400), far apart on screen. The port's render
    is within 1e-3 of a float64 evaluation; the JAX package's, whose
    quadratic form ½(|g|² − (g·r)²/|r|²) cancels terms of size
    (distance/scale)² ≈ 1e6, is off by more than 0.05 in alpha."""
    means = np.array([[2.5, 1.5, 8.0], [-3.0, 0.8, 8.5], [0.5, -2.0, 7.5]], np.float32)
    quats = np.array([[0.9, 0.2, -0.3, 0.1], [0.3, 0.8, 0.1, -0.4], [1, 0, 0, 0]], np.float32)
    scales = np.array([[0.005, 0.03, 0.012], [0.02, 0.006, 0.01], [0.008, 0.008, 0.03]],
                      np.float32)
    opac = np.array([0.9, 0.8, 0.95], np.float32)
    colors = np.eye(3, dtype=np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None]
    f, W, H = 1400.0, 64, 48
    # a 64×48 window around each gaussian's centre: shift the principal point
    alphas = {}
    for i in range(3):
        cx = W / 2 - f * means[i, 0] / means[i, 2]
        cy = H / 2 - f * means[i, 1] / means[i, 2]
        Ks = np.array([[[f, 0, cx], [0, f, cy], [0, 0, 1]]], np.float32)
        args = (means, quats, scales, opac, colors, viewmats, Ks, W, H)
        kw = dict(tile_capacity=256, isect_capacity=1 << 12)
        port = tdgs_torch.rasterization(*args, with_eval3d=True, device="cpu", **kw)[1]
        ref = jax.jit(functools.partial(j_render, width=W, height=H, rasterizer="eval3d",
                                        **kw))(*map(jnp.asarray, args[:7]))[1]
        ys, xs = np.mgrid[0:H, 0:W]
        pix = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5], -1)
        sig = _sigma_f64(means, quats, scales, pix, Ks[0].astype(np.float64))  # [P, 3]
        a = np.minimum(0.999, opac[None] * np.exp(-sig))
        a = np.where(a < 1 / 255, 0.0, a)
        want = 1.0 - np.prod(1.0 - a, axis=-1)  # the others are off screen
        alphas[i] = (port.numpy()[0, ..., 0].ravel(), np.asarray(ref)[0, ..., 0].ravel(),
                     want)
    port_err = max(np.abs(p - w).max() for p, _, w in alphas.values())
    ref_err = max(np.abs(r - w).max() for _, r, w in alphas.values())
    assert max(w.max() for _, _, w in alphas.values()) > 0.5  # the pixels are covered
    assert port_err <= 1e-3, port_err
    assert ref_err > 0.05, ref_err
