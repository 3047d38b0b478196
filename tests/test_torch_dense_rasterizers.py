"""Port parity of the dense plain-tensor rasterizers against the JAX
package: the world-space ``rasterizer="eval3d"`` (``tdgs_torch/ops/
rasterize_eval3d.py``) against ``rasterize_to_pixels_eval3d_jax`` through
the whole ``rasterization`` (global and rolling shutter, outputs and
gradients to the gaussians, colours, opacities and poses) and against the
port's kernel path ``"eval3d_packed"``; the reference's σ* fault on the
dense path; the dense 2DGS ``"jax"`` (``rasterize_2dgs_jax.py``) against
the JAX package's, with JAX handed Mᵀ (``jax_2dgs_fixed``: the JAX
package's 2DGS rasterizers read the ray transform transposed, ROADMAP
faults on the reference side); and ``image_fitting --model-type 2dgs``
against the JAX example.

The scenes are well conditioned (gaussians of scale 0.2–0.4 at depth
about 5), where the JAX package's cancelling σ* form ½(|g|² − (g·r)²/|r|²)
and the port's ½|g × r|²/|r|² agree to float32 rounding; at the bench
scale they do not (``test_reference_fault_dense_sigma``). The JAX side is
jitted.

Tolerances: outputs 1e-4 absolute (the depth channel's and the 2DGS
distortion's and median's scaled by 8, the scene's depth; the 2DGS depth
normals' by 10), gradients max|Δ| ≤ 1e-3 · max|ref| per input; the dense eval3d
against the kernel path, which tiles by ``isect_tiles_packed``, 1e-4
absolute on a scene with well-separated depths; the image fit's first loss
1e-6 absolute and its gradients 1e-3 relative, its later losses 2e-3
relative (its gaussians all start at depth 8, so depths tie).
"""

import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.ops.camera_models import RollingShutterType as JRS
from tdgs.rendering import rasterization as j_render
from tdgs.rendering import rasterization_2dgs as j_render_2dgs
import tdgs_torch
from tdgs_torch.ops.camera_models import RollingShutterType
from tdgs_torch.rendering import rasterization_2dgs as t_render_2dgs
from tests.test_eval3d import K, make_scene
from tests.test_torch_2dgs_training import LEAVES as LEAVES_2DGS
from tests.test_torch_2dgs_training import _scene, jax_2dgs_fixed  # noqa: F401
from tests.test_torch_rasterize_eval3d import _sigma_f64
from tests.test_torch_training import _close_rel

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))

ATOL = 1e-4
RTOL = 1e-3
E3_NAMES = ("means", "quats", "scales", "opacities", "colors", "viewmats")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _e3_scene(seed, N=32):
    rng = np.random.default_rng(seed)
    return make_scene(rng, N=N, spread=0.8, scale_rng=(-1.6, -0.9))


def _end_pose(viewmats, shift):
    end = viewmats.copy()
    end[0, 0, 3] += shift
    return end


@pytest.mark.parametrize("case", ["global", "rolling_shutter"])
def test_dense_eval3d_matches_jax(case):
    """rasterization(rasterizer="eval3d") against the JAX package's, "RGB"
    with a background: outputs, and the gradients of a weighted sum of
    colours and alphas to every input, the pose included (under the
    rolling shutter, both tiled by the shutter-aware UT projection)."""
    inputs = _e3_scene(301 if case == "global" else 302)
    kw = dict(tile_capacity=256, max_tiles_per_gauss=16, isect_capacity=1 << 13,
              backgrounds=np.array([[0.2, 0.4, 0.6]], np.float32))
    jkw, tkw = {}, {}
    if case == "rolling_shutter":
        end = _end_pose(inputs[-1], 0.2)
        jkw = dict(with_ut=True, rolling_shutter=JRS.TOP_TO_BOTTOM, viewmats_rs=jnp.asarray(end))
        tkw = dict(with_ut=True, rolling_shutter=RollingShutterType.TOP_TO_BOTTOM,
                   viewmats_rs=torch.from_numpy(end))
    rng = np.random.default_rng(30)
    cot = (rng.normal(size=(1, 48, 64, 3)).astype(np.float32),
           rng.normal(size=(1, 48, 64, 1)).astype(np.float32))

    def j_loss(*xs):
        img, alp, _ = j_render(*xs, jnp.asarray(K), 64, 48, rasterizer="eval3d", **kw, **jkw)
        return jnp.sum(img * cot[0]) + jnp.sum(alp * cot[1]), (img, alp)

    (_, (j_img, j_alp)), want = jax.jit(jax.value_and_grad(
        j_loss, argnums=tuple(range(6)), has_aux=True))(*map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in inputs]
    img, alp, meta = tdgs_torch.rasterization(*leaves, torch.from_numpy(K), 64, 48,
                                              rasterizer="eval3d", device="cpu", **kw, **tkw)
    assert meta["isect_offsets"].shape == (1, 3, 4) and int(meta["n_dropped"]) == 0
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(j_img), atol=ATOL)
    np.testing.assert_allclose(alp.detach().numpy(), np.asarray(j_alp), atol=ATOL)
    assert float(alp.detach().max()) > 0.5
    got = torch.autograd.grad((img * torch.from_numpy(cot[0])).sum()
                              + (alp * torch.from_numpy(cot[1])).sum(), leaves)
    for name, g, w in zip(E3_NAMES, got, want):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all() and np.abs(w).max() > 0, name
        _close_rel(g.numpy(), w, RTOL, name)


@pytest.mark.parametrize("mode", ["RGB", "RGB+ED"])
def test_dense_eval3d_matches_eval3d_packed(mode):
    """The dense oracle against the port's kernel path (its plain versions
    here, kernels 7 and 8 on the card) on a scene whose depths are well
    apart, so both tilings order every tile alike: outputs and the
    gradients to every input."""
    means, quats, scales, opac, colors, viewmats = _e3_scene(303, N=24)
    means[:, 2] = 3.0 + 0.25 * np.arange(24)  # distinct depths
    inputs = (means, quats, scales, opac, colors, viewmats)
    kw = dict(tile_capacity=256, max_tiles_per_gauss=16, isect_capacity=1 << 13,
              render_mode=mode)
    D = 4 if mode == "RGB+ED" else 3
    w = torch.from_numpy(np.random.default_rng(31).normal(size=(1, 48, 64, D)).astype(np.float32))
    outs = {}
    for r in ("eval3d", "eval3d_packed"):
        leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in inputs]
        img, alp, _ = tdgs_torch.rasterization(*leaves, torch.from_numpy(K), 64, 48,
                                               rasterizer=r, device="cpu", **kw)
        grads = torch.autograd.grad((img * w).sum() + alp.sum(), leaves)
        outs[r] = (img.detach(), alp.detach(), grads)
    a, b = outs["eval3d"], outs["eval3d_packed"]
    scale = 8.0 if mode == "RGB+ED" else 1.0  # the depth channel
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), atol=ATOL * scale)
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), atol=ATOL)
    assert float(a[1].max()) > 0.5
    for name, g, h in zip(E3_NAMES, a[2], b[2]):
        _close_rel(g.numpy(), h.numpy(), RTOL, name)


def test_reference_fault_dense_sigma():
    """Three gaussians at the bench scene's magnitudes (z ≈ 8, off axis,
    scales 0.005–0.03, focal 1400), one at a time in a 64×48 window around
    its centre: the port's dense "eval3d" is within 1e-3 of a float64
    evaluation of its alpha, the JAX package's, whose quadratic form
    cancels terms of size (distance/scale)² ≈ 1e6, off by more than 0.05."""
    means = np.array([[2.5, 1.5, 8.0], [-3.0, 0.8, 8.5], [0.5, -2.0, 7.5]], np.float32)
    quats = np.array([[0.9, 0.2, -0.3, 0.1], [0.3, 0.8, 0.1, -0.4], [1, 0, 0, 0]], np.float32)
    scales = np.array([[0.005, 0.03, 0.012], [0.02, 0.006, 0.01], [0.008, 0.008, 0.03]],
                      np.float32)
    opac = np.array([0.9, 0.8, 0.95], np.float32)
    colors = np.eye(3, dtype=np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None]
    f, W, H = 1400.0, 64, 48
    ys, xs = np.mgrid[0:H, 0:W]
    pix = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5], -1)
    port_err = ref_err = covered = 0.0
    for i in range(3):
        Ks = np.array([[[f, 0, W / 2 - f * means[i, 0] / means[i, 2]],
                        [0, f, H / 2 - f * means[i, 1] / means[i, 2]], [0, 0, 1]]], np.float32)
        args = (means, quats, scales, opac, colors, viewmats, Ks)
        kw = dict(tile_capacity=256, isect_capacity=1 << 12, rasterizer="eval3d")
        port = tdgs_torch.rasterization(*args, W, H, device="cpu", **kw)[1].numpy()
        ref = np.asarray(jax.jit(functools.partial(j_render, width=W, height=H, **kw))(
            *map(jnp.asarray, args))[1])
        sig = _sigma_f64(means, quats, scales, pix, Ks[0].astype(np.float64))  # [P, 3]
        a = np.minimum(0.999, opac[None] * np.exp(-sig))
        want = 1.0 - np.prod(1.0 - np.where(a < 1 / 255, 0.0, a), axis=-1)
        port_err = max(port_err, np.abs(port[0, ..., 0].ravel() - want).max())
        ref_err = max(ref_err, np.abs(ref[0, ..., 0].ravel() - want).max())
        covered = max(covered, want.max())
    assert covered > 0.5
    assert port_err <= 1e-3, port_err
    assert ref_err > 0.05, ref_err


OUT_2DGS = ("colors", "alphas", "normals", "normals_from_depth", "distortion", "median")


@pytest.mark.parametrize("mode", ["RGB", "RGB+ED"])
def test_dense_2dgs_matches_jax(jax_2dgs_fixed, mode):
    """rasterization_2dgs(rasterizer="jax") against the JAX package's, with
    distortion where there is a depth channel, two cameras and the
    screen-space taps: every output, and the gradients of every splat input
    and of both taps; the port's dense path also against its "packed"."""
    s = _scene(610 if mode == "RGB" else 611)
    C, N, H, W = 2, s["means"].shape[0], s["height"], s["width"]
    kw = dict(sh_degree=1, tile_capacity=256, max_tiles_per_gauss=16,
              isect_capacity=1 << 13, render_mode=mode, distloss=mode != "RGB")
    rng = np.random.default_rng(62)
    D = 4 if mode == "RGB+ED" else 3
    cot = [rng.normal(size=(C, H, W, k)).astype(np.float32) for k in (D, 1, 3, 3, 1)]
    n_out = 5 if mode == "RGB+ED" else 3

    def j_loss(*xs):
        *leaves, tap, abs_tap = xs
        out = j_render_2dgs(*leaves, jnp.asarray(s["viewmats"]), jnp.asarray(s["Ks"]), W, H,
                            rasterizer="jax", backgrounds=jnp.asarray(s["backgrounds"]),
                            means2d_offset=tap, means2d_abs_tap=abs_tap, **kw)
        return sum(jnp.sum(o * c) for o, c in zip(out[:n_out], cot)), out[:6]

    zeros = np.zeros((C, N, 2), np.float32)
    xs = [s[k] for k in LEAVES_2DGS] + [zeros, zeros]
    (_, want_out), want = jax.jit(jax.value_and_grad(
        j_loss, argnums=tuple(range(7)), has_aux=True))(*map(jnp.asarray, xs))
    leaves = [torch.tensor(x, requires_grad=True) for x in xs]
    out = t_render_2dgs(*leaves[:5], s["viewmats"], s["Ks"], W, H, rasterizer="jax",
                        backgrounds=s["backgrounds"], means2d_offset=leaves[5],
                        means2d_abs_tap=leaves[6], device="cpu", **kw)
    assert out[6]["isect_offsets"].shape == (C, 2, 3) and int(out[6]["n_dropped"]) == 0
    for name, g, w in zip(OUT_2DGS, out[:6], want_out):
        if w is None:
            assert g is None, name
            continue
        # the depth channel is ~5; the depth normals normalize its finite
        # differences, which magnifies its float32 rounding tenfold
        scale = {"colors": 8.0, "median": 8.0, "distortion": 8.0,
                 "normals_from_depth": 10.0}.get(name, 1.0) if mode != "RGB" else 1.0
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL * scale,
                                   err_msg=name)
    assert float(out[1].detach().max()) > 0.5
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out[:n_out], cot))
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(LEAVES_2DGS + ("means2d_tap", "abs_tap"), got, want):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all() and np.abs(w).max() > 0, name
        _close_rel(g.numpy(), w, RTOL, name)
    packed = t_render_2dgs(*(x.detach() for x in leaves[:5]), s["viewmats"], s["Ks"], W, H,
                           rasterizer="packed", backgrounds=s["backgrounds"], device="cpu",
                           **kw)
    for name, g, w in zip(OUT_2DGS[:5], packed[:5], out[:5]):
        if w is not None:
            np.testing.assert_allclose(g.numpy(), w.detach().numpy(), atol=2e-3, err_msg=name)


def test_image_fitting_2dgs_follows_the_jax_example(jax_2dgs_fixed, capsys):
    """The JAX example's surfel fit (its init_params, target, camera,
    render arguments and optax.adam, jitted as its step is) against the
    port's ``fit(model_type="2dgs", rasterizer="jax")`` from the same
    parameters: the first gradients and the first losses agree; the port's
    "packed" path starts from the same loss."""
    import image_fitting as j_fit
    import optax
    from tdgs_torch import image_fitting as t_fit

    H = W = 48
    n, steps, lr = 128, 4, 2e-2
    params = j_fit.init_params(jax.random.PRNGKey(42), n)
    init = {k: np.asarray(v) for k, v in params.items()}
    target = jnp.asarray(j_fit.make_target_image(H, W))
    viewmats, Ks = j_fit.build_camera(H, W)

    def j_loss(p):
        img = j_render_2dgs(p["means"], p["quats"], jnp.exp(p["scales"]),
                            jax.nn.sigmoid(p["opacities"]), jax.nn.sigmoid(p["colors"]),
                            viewmats, Ks, W, H, tile_capacity=512, isect_capacity=None,
                            max_tiles_per_gauss=64)[0][0]
        return jnp.mean((img - target) ** 2)

    tx = optax.adam(lr)

    @jax.jit
    def step(p, opt_state):
        loss, grads = jax.value_and_grad(j_loss)(p)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(p, updates), opt_state, loss, grads

    opt_state = tx.init(params)
    j_log, j_grads = [], None
    for _ in range(steps):
        params, opt_state, loss, grads = step(params, opt_state)
        j_log.append(float(loss))
        j_grads = grads if j_grads is None else j_grads

    t_init, _, t_img = t_fit.fit(height=H, width=W, num_points=n, iterations=steps, lr=lr,
                                 log_every=1, model_type="2dgs", init=init, rasterizer="jax",
                                 device="cpu")
    t_log = [float(x.split()[-1]) for x in capsys.readouterr().out.splitlines()
             if x.startswith("iter")]
    assert len(t_log) == steps and t_img.shape == (H, W, 3) and np.isfinite(t_img).all()
    np.testing.assert_allclose(t_init, j_log[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_log[0], j_log[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_log[1:], j_log[1:], rtol=2e-3)

    tvm, tK = t_fit.build_camera(H, W, device="cpu")
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    loss = ((t_fit.render(leaves, tvm, tK, W, H, "jax", "2dgs")
             - torch.from_numpy(t_fit.make_target_image(H, W))) ** 2).mean()
    got = torch.autograd.grad(loss, list(leaves.values()))
    for k, g in zip(leaves, got):
        _close_rel(g.numpy(), np.asarray(j_grads[k]), RTOL, k)
    p_init, _, _ = t_fit.fit(height=H, width=W, num_points=n, iterations=1, log_every=0,
                             model_type="2dgs", init=init, device="cpu")
    np.testing.assert_allclose(p_init, j_log[0], rtol=1e-4)
