"""Port parity of the 2DGS projection and the depth-map geometry:
``tdgs_torch.ops.projection_2dgs.fully_fused_projection_2dgs`` and
``tdgs_torch.utils.depth`` against the JAX package's, outputs and
``jax.grad`` gradients, on the same numpy inputs.

Tolerances: outputs 1e-5 relative to each output's scale (radii equal);
gradients max|Δ| ≤ 1e-4 · max|ref|, as the 3DGS projection's parity test
holds them.

The port's surfel normal is the unit third axis, t_u × t_v, as the 2DGS
paper and gsplat's CUDA projection take it; the JAX package's is that axis
times the third scale (ROADMAP, faults on the reference side). The tests
divide the JAX normal by that scale (``_j_project_unit``), and
``test_jax_normal_carries_the_third_scale`` shows the difference.
"""

import numpy as np
import jax.numpy as jnp
import torch

from tdgs.ops.projection_2dgs import fully_fused_projection_2dgs as j_project
from tdgs.utils import depth as jdepth
from tdgs_torch.ops.projection_2dgs import fully_fused_projection_2dgs as t_project
from tdgs_torch.utils import depth as tdepth
from tests.test_torch_training import _close_rel, _jax_and_torch_grads

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _surfels(seed, N=64, C=2):
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(N, 3)) * [1.5, 1.0, 1.0] + [0, 0, 4]).astype(np.float32)
    means[:4, 2] = -1.0  # behind the camera: culled
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.4, size=(N, 3)).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[1, :3, 3] = [0.3, -0.2, 0.4]
    Ks = np.tile(np.array([[60.0, 0, 32], [0, 58, 24], [0, 0, 1]], np.float32), (C, 1, 1))
    return rng, means, quats, scales, viewmats, Ks


def _j_project_unit(means, quats, scales, *args, **kwargs):
    """The JAX projection with its normal divided by the third scale."""
    out = j_project(means, quats, scales, *args, **kwargs)
    return out[:4] + (out[4] / scales[..., None, :, 2:3],)


def test_jax_normal_carries_the_third_scale():
    _, means, quats, scales, viewmats, Ks = _surfels(1)
    want = j_project(*map(jnp.asarray, (means, quats, scales, viewmats, Ks)), 64, 48)
    got = t_project(*map(torch.from_numpy, (means, quats, scales, viewmats, Ks)), 64, 48)
    np.testing.assert_allclose(np.linalg.norm(got[4].numpy(), axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(want[4]), axis=-1),
                               np.broadcast_to(scales[:, 2], want[4].shape[:-1]), rtol=1e-5)


def test_projection_2dgs_outputs_match_jax():
    _, means, quats, scales, viewmats, Ks = _surfels(1)
    want = _j_project_unit(*map(jnp.asarray, (means, quats, scales, viewmats, Ks)), 64, 48)
    got = t_project(*map(torch.from_numpy, (means, quats, scales, viewmats, Ks)), 64, 48)
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[0].numpy() == 0).all(-1).any() and (got[0].numpy() > 0).any()
    for name, g, w in zip(("means2d", "depths", "ray_transforms", "normals"), got[1:], want[1:]):
        _close_rel(g.numpy(), np.asarray(w), OUT_RTOL, name)


def test_projection_2dgs_gradients_match_jax():
    rng, means, quats, scales, viewmats, Ks = _surfels(2)
    C, N = viewmats.shape[0], means.shape[0]
    weights = [rng.normal(size=s).astype(np.float32)
               for s in ((C, N, 2), (C, N), (C, N, 3, 3), (C, N, 3))]

    def run(proj, vm, K):
        def fn(m, q, s):
            return list(proj(m, q, s, vm, K, 64, 48)[1:])
        return fn

    want, got = _jax_and_torch_grads(
        run(_j_project_unit, jnp.asarray(viewmats), jnp.asarray(Ks)),
        run(t_project, torch.from_numpy(viewmats), torch.from_numpy(Ks)),
        [means, quats, scales], weights)
    for name, g, w in zip(("means", "quats", "scales"), got, want):
        assert np.isfinite(g).all(), name
        _close_rel(g, w, GRAD_RTOL, name)


def _depth_inputs(seed, H=20, W=24):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    depth = (3.0 + 0.05 * xx + 0.02 * yy + 0.1 * rng.normal(size=(H, W)))[None, ..., None]
    depth[0, 5:12, 6:14] = 2.5  # a flat region: zero cross products there
    depth = np.concatenate([depth, depth[:, ::-1] + 0.5]).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2w[1, :3, :3] = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    c2w[1, :3, 3] = [0.5, 0.1, -0.2]
    Ks = np.tile(np.array([[30.0, 0, 12], [0, 28, 10], [0, 0, 1]], np.float32), (2, 1, 1))
    return rng, depth, c2w, Ks


def test_depth_to_points_and_normals_match_jax():
    _, depth, c2w, Ks = _depth_inputs(3)
    args_j = map(jnp.asarray, (depth, c2w, Ks))
    args_t = [torch.from_numpy(x) for x in (depth, c2w, Ks)]
    pts_j = jdepth.depth_to_points(*map(jnp.asarray, (depth, c2w, Ks)))
    _close_rel(tdepth.depth_to_points(*args_t).numpy(), np.asarray(pts_j), OUT_RTOL, "points")
    n_j = np.asarray(jdepth.depth_to_normal(*args_j))
    n_t = tdepth.depth_to_normal(*args_t).numpy()
    np.testing.assert_allclose(n_t, n_j, atol=1e-5)
    assert (n_t[:, 0] == 0).all() and (n_t[:, :, -1] == 0).all()  # the zero border


def test_depth_to_normal_gradients_are_finite_on_flat_regions():
    """The flat patch and the zero border give zero cross products; the
    n·rsqrt(Σn² + ε) form keeps their gradients finite, and both packages
    agree on them."""
    rng, depth, c2w, Ks = _depth_inputs(4)
    weights = [rng.normal(size=depth.shape[:-1] + (3,)).astype(np.float32)]
    want, got = _jax_and_torch_grads(
        lambda d: [jdepth.depth_to_normal(d, jnp.asarray(c2w), jnp.asarray(Ks))],
        lambda d: [tdepth.depth_to_normal(d, torch.from_numpy(c2w), torch.from_numpy(Ks))],
        [depth], weights)
    assert np.isfinite(got[0]).all()
    _close_rel(got[0], want[0], GRAD_RTOL, "d normals / d depth")
    # a constant depth map: every cross product on the flat plane is
    # parallel to the view axis, the border is zero; still finite
    flat = torch.full((1, 8, 8, 1), 2.0, requires_grad=True)
    n = tdepth.depth_to_normal(flat, torch.eye(4)[None], torch.from_numpy(Ks[:1]))
    (n * torch.randn(n.shape, generator=torch.Generator().manual_seed(0))).sum().backward()
    assert bool(torch.isfinite(flat.grad).all())


def test_log_transform_and_projection_matrix_match_jax():
    x = np.linspace(-5, 5, 41).astype(np.float32)
    np.testing.assert_allclose(tdepth.log_transform(torch.from_numpy(x)).numpy(),
                               np.asarray(jdepth.log_transform(jnp.asarray(x))), rtol=1e-6)
    y = tdepth.log_transform(torch.from_numpy(x))
    np.testing.assert_allclose(tdepth.inverse_log_transform(y).numpy(), x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tdepth.get_projection_matrix(0.01, 100.0, 1.1, 0.8).numpy(),
        np.asarray(jdepth.get_projection_matrix(0.01, 100.0, 1.1, 0.8)), rtol=1e-6)


def test_rotate_is_true_float32():
    """rotate() is elementwise: the same as a float64 product to float32
    rounding, whatever the matmul precision setting."""
    rng = np.random.default_rng(5)
    R = rng.normal(size=(2, 3, 3)).astype(np.float32)
    v = rng.normal(size=(2, 5, 6, 3)).astype(np.float32) * 1e3
    got = tdepth.rotate(torch.from_numpy(R), torch.from_numpy(v)).numpy()
    want = np.einsum("bij,bhwj->bhwi", R.astype(np.float64), v.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
