"""Port parity: transforms, EWA projection and SH of ``tdgs_torch`` against
``tdgs`` on the same numpy inputs (CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops import projection as jproj
from tdgs.ops import sh as jsh
from tdgs.ops import transforms as jtr
from tdgs_torch.ops import projection as tproj
from tdgs_torch.ops import sh as tsh
from tdgs_torch.ops import transforms as ttr

# float32 elementwise chains evaluated in the same order: both sides round
# alike to within a few ulps of values of order 1
ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    if isinstance(got, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, **kw)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **kw)


def _quats_scales(rng, n=64):
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 0.5, size=(n, 3)).astype(np.float32)
    return quats, scales


def _viewmats(rng, C=2):
    q = rng.normal(size=(C, 4)).astype(np.float32)
    R = np.asarray(jtr.quat_to_rotmat(jnp.asarray(q)))
    vm = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    vm[:, :3, :3] = R
    vm[:, :3, 3] = rng.normal(size=(C, 3)) * 0.2
    return vm


@pytest.mark.parametrize(
    "name",
    ["quat_normalize", "quat_to_rotmat", "rotmat_to_quat", "quat_mul",
     "quat_rotate", "covar_preci", "covar_preci_triu", "covar_sym6",
     "covar_cam_sym6", "pos_world_to_cam", "world_to_cam"],
)
def test_transforms_match(name):
    rng = np.random.default_rng(200)
    q, s = _quats_scales(rng)
    q2 = rng.normal(size=q.shape).astype(np.float32)
    v = rng.normal(size=(q.shape[0], 3)).astype(np.float32)
    means = rng.normal(size=(q.shape[0], 3)).astype(np.float32)
    vm = _viewmats(rng)
    J, T = jnp.asarray, _t
    if name == "quat_normalize":
        _close(ttr.quat_normalize(T(q)), jtr.quat_normalize(J(q)), atol=ATOL)
    elif name == "quat_to_rotmat":
        _close(ttr.quat_to_rotmat(T(q)), jtr.quat_to_rotmat(J(q)), atol=ATOL)
    elif name == "rotmat_to_quat":
        R = np.asarray(jtr.quat_to_rotmat(J(q)))
        _close(ttr.rotmat_to_quat(T(R)), jtr.rotmat_to_quat(J(R)), atol=ATOL)
    elif name == "quat_mul":
        _close(ttr.quat_mul(T(q), T(q2)), jtr.quat_mul(J(q), J(q2)), atol=ATOL)
    elif name == "quat_rotate":
        _close(ttr.quat_rotate(T(q), T(v)), jtr.quat_rotate(J(q), J(v)),
               atol=ATOL)
    elif name in ("covar_preci", "covar_preci_triu"):
        triu = name.endswith("triu")
        got = ttr.quat_scale_to_covar_preci(T(q), T(s), triu=triu)
        want = jtr.quat_scale_to_covar_preci(J(q), J(s), triu=triu)
        # precisions reach 1/0.05² = 400: compare relative to that scale
        _close(got[0], want[0], atol=ATOL)
        _close(got[1], want[1], rtol=1e-5, atol=1e-4)
    elif name == "covar_sym6":
        _close(ttr.quat_scale_to_covar_sym6(T(q), T(s)),
               jtr.quat_scale_to_covar_sym6(J(q), J(s)), atol=ATOL)
    elif name == "covar_cam_sym6":
        c6 = jtr.quat_scale_to_covar_sym6(J(q), J(s))
        _close(ttr.covar_cam_sym6(tuple(T(c) for c in c6), T(vm)),
               jtr.covar_cam_sym6(c6, J(vm)), atol=ATOL)
    elif name == "pos_world_to_cam":
        _close(ttr.pos_world_to_cam(T(means), T(vm)),
               jtr.pos_world_to_cam(J(means), J(vm)), atol=ATOL)
    else:
        cov = np.asarray(jtr.quat_scale_to_covar_preci(J(q), J(s))[0])
        _close(ttr.world_to_cam(T(means), T(cov), T(vm)),
               jtr.world_to_cam(J(means), J(cov), J(vm)), atol=ATOL)


def _scene(rng, N=96):
    means = (rng.normal(size=(N, 3)) * [1.0, 0.8, 0.5] + [0, 0, 4.0]).astype(np.float32)
    quats, scales = _quats_scales(rng, N)
    scales *= 0.5
    opac = rng.uniform(0.002, 1.0, size=(N,)).astype(np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    viewmats[1, :3, 3] = [0.3, -0.1, 0.5]
    Ks = np.array([[60.0, 0, 32], [0, 58, 24], [0, 0, 1]], np.float32)[None].repeat(2, 0)
    return means, quats, scales, opac, viewmats, Ks


def _radii_agree(got, want, pre_ceil):
    """Equal, except ±1 where the value before ceil lies within 1e-4 of an
    integer (one float32 rounding can move ceil there)."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    near = np.abs(pre_ceil - np.round(pre_ceil)) < 1e-4
    assert ((diff == 0) | ((diff == 1) & near)).all(), np.argwhere(diff > 0)


@pytest.mark.parametrize("antialiased", [False, True])
@pytest.mark.parametrize("with_opacities", [False, True])
@pytest.mark.parametrize("with_covars", [False, True])
def test_fully_fused_projection_matches(antialiased, with_opacities, with_covars):
    rng = np.random.default_rng(201)
    means, quats, scales, opac, viewmats, Ks = _scene(rng)
    covars = None
    if with_covars:
        covars = np.asarray(jtr.quat_scale_to_covar_preci(
            jnp.asarray(quats), jnp.asarray(scales))[0])
    kw = dict(calc_compensations=antialiased, eps2d=0.3)
    want = jproj.fully_fused_projection(
        jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
        jnp.asarray(viewmats), jnp.asarray(Ks), 64, 48,
        opacities=jnp.asarray(opac) if with_opacities else None,
        covars=None if covars is None else jnp.asarray(covars), **kw,
    )
    got = tproj.fully_fused_projection(
        _t(means), _t(quats), _t(scales), _t(viewmats), _t(Ks), 64, 48,
        opacities=_t(opac) if with_opacities else None,
        covars=None if covars is None else _t(covars), **kw,
    )
    radii_w, radii_g = np.asarray(want[0]), got[0].numpy()
    assert radii_g.dtype == np.int32
    live = (radii_w > 0).all(-1) & (radii_g > 0).all(-1)
    # float32 rounding of the same expressions: relative 1e-5
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live],
                                   rtol=1e-5, atol=1e-5)
    # radii before ceil, from the reference's own conic chain
    conics = np.asarray(want[3])
    det = conics[..., 0] * conics[..., 2] - conics[..., 1] ** 2
    c00b = conics[..., 2] / np.maximum(det, 1e-30)
    c11b = conics[..., 0] / np.maximum(det, 1e-30)
    extend = np.full(det.shape, 3.33, np.float32)
    if with_opacities:
        op = np.broadcast_to(opac, det.shape)
        if antialiased:
            op = op * np.asarray(want[4])
        extend = np.minimum(extend, np.sqrt(2.0 * np.log(
            np.maximum(op, 1 / 255) * 255)))
    pre = np.stack([extend * np.sqrt(c00b), extend * np.sqrt(c11b)], -1)
    _radii_agree(radii_g, radii_w, pre)
    if antialiased:
        np.testing.assert_allclose(got[4].numpy()[live], np.asarray(want[4])[live],
                                   rtol=1e-5, atol=1e-6)
    else:
        assert got[4] is None and want[4] is None


@pytest.mark.parametrize("camera_model", ["ortho", "fisheye"])
def test_projection_ortho_fisheye_match(camera_model):
    """The ortho and fisheye EWA projections give JAX's outputs (float32
    rounding of the same expressions: rtol 1e-5, atol 1e-6) and radii."""
    rng = np.random.default_rng(202)
    means, quats, scales, opac, viewmats, Ks = _scene(rng, 96)
    if camera_model == "ortho":
        # pixels per world unit that frame the scene
        Ks = Ks.copy()
        Ks[:, 0, 0] = Ks[:, 1, 1] = 20.0
    args = (means, quats, scales, viewmats, Ks)
    want = jproj.fully_fused_projection(*map(jnp.asarray, args), 64, 48,
                                        opacities=jnp.asarray(opac), camera_model=camera_model)
    got = tproj.fully_fused_projection(*map(_t, args), 64, 48, opacities=_t(opac),
                                       camera_model=camera_model)
    radii_w, radii_g = np.asarray(want[0]), got[0].numpy()
    live = (radii_w > 0).all(-1)
    assert live.sum() > 20
    np.testing.assert_array_equal(radii_g, radii_w)
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_spherical_harmonics_match(degree):
    rng = np.random.default_rng(203 + degree)
    n, K = 80, 25
    dirs = rng.normal(size=(2, n, 3)).astype(np.float32)
    coeffs = (rng.normal(size=(2, n, K, 3)) * 0.3).astype(np.float32)
    masks = rng.uniform(size=(2, n)) > 0.2
    got = tsh.spherical_harmonics(degree, _t(dirs), _t(coeffs), masks=_t(masks))
    want = jsh.spherical_harmonics(degree, jnp.asarray(dirs), jnp.asarray(coeffs),
                                   masks=jnp.asarray(masks))
    # sums of ≤25 products of terms below 1: float32 rounding well under 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
