"""Port parity of the camera models and the unscented-transform projection
(``tdgs_torch.ops.camera_models``, ``tdgs_torch.ops.projection_ut``)
against the JAX package's (``tdgs.ops.camera_models``,
``tdgs.ops.projection_ut``): OpenCV pinhole with rational radial,
tangential and thin-prism distortion, OpenCV fisheye, FTheta, ortho, the
rolling-shutter timing and pose interpolation, and the UT projection's
outputs and gradients.

Tolerances: pixels 1e-3 (of a few hundred), unit directions and poses
1e-5, UT means2d 1e-3 pixels, depths 1e-5, conics and compensations 1e-4
relative to their largest value; radii must agree for all but 1% of the
gaussians (a ceil at an integer boundary may round the other way);
gradients max|Δ| ≤ 1e-3 · max|ref| per input.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops import camera_models as jcm
from tdgs.ops.projection_ut import fully_fused_projection_with_ut as j_ut
from tdgs_torch.ops import camera_models as tcm
from tdgs_torch.ops.projection_ut import fully_fused_projection_with_ut as t_ut

K = np.array([[[300.0, 0, 96], [0, 280.0, 64], [0, 0, 1]]], np.float32)
FTHETA = dict(pixeldist_to_angle_poly=(0.0, 0.0033, 0.0, 4e-9, 0.0, 0.0),
              angle_to_pixeldist_poly=(0.0, 300.0, 0.0, -30.0, 0.0, 0.0))
CAMERAS = {
    "pinhole": ("pinhole", {}),
    "pinhole_distorted": ("pinhole", dict(
        radial_coeffs=[[0.05, -0.01, 0.002, 0.01, 0.0, 0.0]],
        tangential_coeffs=[[0.004, -0.003]], thin_prism_coeffs=[[0.001, 0.0, -0.002, 0.0]])),
    "fisheye": ("fisheye", dict(radial_coeffs=[[0.03, -0.01, 0.004, -0.001]])),
    "ftheta": ("ftheta", {}),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _coeffs(name, lead=()):
    """(JAX kwargs, port kwargs) of a camera's distortion, with leading
    dims ``lead`` inserted after the camera axis."""
    model, coeffs = CAMERAS[name]
    j, t = {}, {}
    for k, v in coeffs.items():
        a = np.array(v, np.float32).reshape((1,) + (1,) * len(lead) + (-1,))
        j[k], t[k] = jnp.asarray(a), torch.from_numpy(a)
    if model == "ftheta":
        j["ftheta_coeffs"] = jcm.FThetaCameraDistortionParameters(**FTHETA)
        t["ftheta_coeffs"] = tcm.FThetaCameraDistortionParameters(**FTHETA)
    return model, j, t


def _points(seed, n=300):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.45, 0.45, size=(1, n, 2))
    z = rng.uniform(1.0, 8.0, size=(1, n, 1))
    return np.concatenate([xy * z, z], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["pinhole", "pinhole_distorted", "fisheye", "ftheta", "ortho"])
def test_project_and_unproject_match_jax(name):
    p = _points(11)
    if name == "ortho":
        model, jk, tk = "ortho", {}, {}
    else:
        model, jk, tk = _coeffs(name, lead=(1,))
    proj = jax.jit(functools.partial(jcm.project_point, camera_model=model, **jk))
    want, want_valid = proj(jnp.asarray(p), jnp.asarray(K)[:, None])
    got, got_valid = tcm.project_point(torch.from_numpy(p), torch.from_numpy(K)[:, None],
                                       model, **tk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    if name == "ortho":
        return
    pix = np.array(want)
    unproj = jax.jit(functools.partial(jcm.unproject_pixel, camera_model=model, **jk))
    want_d = unproj(jnp.asarray(pix), jnp.asarray(K)[:, None])
    got_d = tcm.unproject_pixel(torch.from_numpy(pix), torch.from_numpy(K)[:, None], model, **tk)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)
    if name != "ftheta":  # the FTheta polynomials are only an approximate inverse pair
        d_ref = p / np.linalg.norm(p, axis=-1, keepdims=True)
        np.testing.assert_allclose(got_d.numpy(), d_ref, atol=2e-4)


def test_rolling_shutter_timing_and_pose_interpolation_match_jax():
    rng = np.random.default_rng(12)
    pix = rng.uniform(-10, 200, size=(64, 2)).astype(np.float32)
    for rs in jcm.RollingShutterType:
        want = jcm.shutter_time_from_pixel(jnp.asarray(pix), 192, 128, rs)
        got = tcm.shutter_time_from_pixel(torch.from_numpy(pix), 192, 128,
                                          tcm.RollingShutterType(int(rs)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, err_msg=rs.name)

    def pose(q, t):
        q = q / np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = R, t
        return m.astype(np.float32)

    start = np.stack([pose(rng.normal(size=4), rng.normal(size=3)) for _ in range(3)])
    end = np.stack([pose(rng.normal(size=4), rng.normal(size=3)) for _ in range(3)])
    t = rng.uniform(0, 1, size=(5, 3)).astype(np.float32)
    want = jax.jit(jcm.interpolate_pose)(jnp.asarray(start), jnp.asarray(end), jnp.asarray(t))
    got = tcm.interpolate_pose(*map(torch.from_numpy, (start, end, t)))
    assert got.shape == (5, 3, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _gaussians(seed, N=64):
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(N, 3)) * [1.2, 0.8, 0.6] + [0, 0, 5]).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.0, -1.5, size=(N, 3))).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, size=(N,)).astype(np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    viewmats[1, :3, 3] = [0.3, -0.1, 0.2]
    return means, quats, scales, opac, viewmats


def _ut_inputs(name):
    means, quats, scales, opac, viewmats = _gaussians(13)
    Ks = np.repeat(K, 2, 0)
    kw_j, kw_t = dict(calc_compensations=True), dict(calc_compensations=True)
    if name == "rolling_shutter":
        end = viewmats.copy()
        end[:, :3, 3] += [0.15, 0.05, -0.05]
        kw_j.update(rolling_shutter=jcm.RollingShutterType.LEFT_TO_RIGHT,
                    viewmats_rs=jnp.asarray(end))
        kw_t.update(rolling_shutter=tcm.RollingShutterType.LEFT_TO_RIGHT,
                    viewmats_rs=torch.from_numpy(end))
        model = "pinhole"
    else:
        model, j, t = _coeffs(name)
        for k in j:
            if k != "ftheta_coeffs":
                j[k], t[k] = jnp.repeat(j[k], 2, 0), t[k].repeat(2, 1)
        kw_j.update(j)
        kw_t.update(t)
    return (means, quats, scales, opac, viewmats, Ks), model, kw_j, kw_t


@pytest.mark.parametrize("name", ["pinhole_distorted", "fisheye", "ftheta", "rolling_shutter"])
def test_ut_projection_matches_jax(name):
    args, model, kw_j, kw_t = _ut_inputs(name)
    f = jax.jit(functools.partial(j_ut, width=192, height=128, camera_model=model, **kw_j))
    want = [np.asarray(x) for x in f(*map(jnp.asarray, args))]
    got = [x.numpy() for x in t_ut(*map(torch.from_numpy, args), 192, 128,
                                   camera_model=model, **kw_t)]
    radii, means2d, depths, conics, comp = got
    assert radii.dtype == np.int32 and radii.shape == want[0].shape
    assert (radii != want[0]).any(-1).mean() <= 0.01
    assert (want[0] > 0).all(-1).mean() > 0.5  # most gaussians are kept
    ok = (radii > 0).all(-1) & (want[0] > 0).all(-1)
    np.testing.assert_allclose(means2d[ok], want[1][ok], atol=1e-3)
    np.testing.assert_allclose(depths, want[2], atol=1e-5)
    for g, w in ((conics[ok], want[3][ok]), (comp, want[4])):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def test_ut_projection_gradients_match_jax():
    """Autograd through the port's UT projection (distorted pinhole) against
    jax.grad, for a weighted sum of means2d and conics."""
    args, model, kw_j, kw_t = _ut_inputs("pinhole_distorted")
    kw_j["calc_compensations"] = kw_t["calc_compensations"] = False
    rng = np.random.default_rng(14)
    w_m = rng.normal(size=(2, 64, 2)).astype(np.float32)
    w_c = rng.normal(size=(2, 64, 3)).astype(np.float32)

    def j_loss(means, quats, scales):
        _, m2, _, con, _ = j_ut(means, quats, scales, jnp.asarray(args[3]),
                                jnp.asarray(args[4]), jnp.asarray(args[5]), 192, 128,
                                camera_model=model, **kw_j)
        return jnp.sum(m2 * w_m) + jnp.sum(con * w_c)

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(*map(jnp.asarray, args[:3]))
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args[:3]]
    _, m2, _, con, _ = t_ut(*leaves, *map(torch.from_numpy, args[3:]), 192, 128,
                            camera_model=model, **kw_t)
    loss = (m2 * torch.from_numpy(w_m)).sum() + (con * torch.from_numpy(w_c)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(("means", "quats", "scales"), got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-3 * np.abs(w).max(), name
