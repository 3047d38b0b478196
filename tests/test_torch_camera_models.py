"""Port parity of the ortho and fisheye EWA cameras against the JAX package
on the CPU: the fused projection's outputs and autograd's gradients against
``jax.grad`` (a gaussian on the optical axis among them), the unfused
``proj`` of each camera model, and the Inria-convention wrappers.

Tolerances: outputs rtol 1e-5 and atol 1e-6 (float32 rounding of the same
expressions); gradients 1e-4 relative to the reference's largest value.
On the optical axis both frameworks take the square root of 0: the means'
gradient of that gaussian is NaN in JAX, and the test asserts the same.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tdgs
from tdgs.ops import projection as jproj
from tdgs_torch import rendering as trend
from tdgs_torch.ops import projection as tproj

W, H = 64, 48


def _scene(rng, camera_model, N=120):
    means = (rng.normal(size=(N, 3)) * [1.0, 0.8, 0.5] + [0, 0, 4.0]).astype(np.float32)
    means[0] = [0.0, 0.0, 4.0]  # on the first camera's optical axis
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.25, size=(N, 3)).astype(np.float32)
    opac = rng.uniform(0.05, 1.0, size=(N,)).astype(np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    viewmats[1, :3, 3] = [0.3, -0.1, 0.5]
    # fisheye: f·θ spans the image at θ ≈ 90°; ortho: pixels per unit
    f = {"fisheye": 20.0, "ortho": 20.0, "pinhole": 60.0}[camera_model]
    Ks = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)[None].repeat(2, 0)
    return means, quats, scales, opac, viewmats, Ks


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.nanmax(np.abs(np.asarray(got, np.float64) - want))) / max(
        float(np.nanmax(np.abs(want))), 1e-30)


@pytest.mark.parametrize("antialiased", [False, True])
@pytest.mark.parametrize("camera_model", ["ortho", "fisheye"])
def test_projection_gradients_match_jax(camera_model, antialiased):
    rng = np.random.default_rng(31)
    means, quats, scales, opac, viewmats, Ks = _scene(rng, camera_model)
    cot = [rng.normal(size=s).astype(np.float32) for s in ((2, 120, 2), (2, 120), (2, 120, 3))]

    def jax_loss(m, q, s, o, vm):
        radii, m2, d, c, comp = jproj.fully_fused_projection(
            m, q, s, vm, jnp.asarray(Ks), W, H, opacities=o,
            calc_compensations=antialiased, camera_model=camera_model)
        live = (radii > 0).all(-1)
        loss = (jnp.where(live[..., None], m2 * cot[0], 0).sum()
                + jnp.where(live, d * cot[1], 0).sum()
                + jnp.where(live[..., None], c * cot[2], 0).sum())
        if antialiased:
            loss = loss + jnp.where(live, comp, 0).sum()
        return loss

    args = (means, quats, scales, opac, viewmats)
    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    radii, m2, d, c, comp = tproj.fully_fused_projection(
        *leaves[:3], leaves[4], torch.tensor(Ks), W, H, opacities=leaves[3],
        calc_compensations=antialiased, camera_model=camera_model)
    live = (radii > 0).all(-1)
    T = torch.from_numpy
    loss = ((m2 * T(cot[0]))[live].sum() + (d * T(cot[1]))[live].sum()
            + (c * T(cot[2]))[live].sum())
    if antialiased:
        loss = loss + comp[live].sum()
    # without compensation the opacities only cull and size the radii
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    for name, g, w, leaf in zip(("means", "quats", "scales", "opacities", "viewmats"), got,
                                want, leaves):
        g, w = (torch.zeros_like(leaf) if g is None else g).numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        assert _rel(g, w) <= 1e-4, (name, _rel(g, w))
    # the optical axis: sqrt(0) in both, pinned to what JAX gives
    on_axis = np.asarray(want[0])[0]
    if camera_model == "fisheye":
        assert np.isnan(on_axis).all() and np.isnan(got[0][0].numpy()).all()
    else:
        assert np.isfinite(got[0][0].numpy()).all()


@pytest.mark.parametrize("camera_model", ["pinhole", "ortho", "fisheye"])
def test_unfused_proj_matches_jax(camera_model):
    rng = np.random.default_rng(32)
    means, quats, scales, _, _, Ks = _scene(rng, camera_model)
    from tdgs.ops.transforms import quat_scale_to_covar_preci

    covars = np.asarray(quat_scale_to_covar_preci(jnp.asarray(quats), jnp.asarray(scales))[0])
    m, cv, K = means[None], covars[None], Ks[:1]
    want = jproj.proj(jnp.asarray(m), jnp.asarray(cv), jnp.asarray(K), W, H, camera_model)
    got = tproj.proj(torch.tensor(m), torch.tensor(cv), torch.tensor(K), W, H, camera_model)
    named = {"pinhole": tproj.proj, "ortho": tproj.ortho_proj,
             "fisheye": tproj.fisheye_proj}[camera_model]
    again = named(torch.tensor(m), torch.tensor(cv), torch.tensor(K), W, H)
    for g, a, w in zip(got, again, want):
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
        assert torch.equal(g, a)
    with pytest.raises(ValueError, match="camera_model"):
        tproj.proj(torch.tensor(m), torch.tensor(cv), torch.tensor(K), W, H, "equirect")


@pytest.fixture
def jax_2dgs_fixed(monkeypatch):
    """The JAX package's 2DGS path with Mᵀ handed to its rasterizers (it
    reads its ray transform transposed: ROADMAP, faults on the reference
    side; as ``tests/test_torch_2dgs_training.py``)."""
    import tdgs.ops.projection_2dgs as jproj2

    project = jproj2.fully_fused_projection_2dgs

    def transposed(*args, **kwargs):
        radii, means2d, depths, M, normals = project(*args, **kwargs)
        return radii, means2d, depths, jnp.swapaxes(M, -1, -2), normals

    monkeypatch.setattr(jproj2, "fully_fused_projection_2dgs", transposed)


def test_inria_wrappers_match_jax(jax_2dgs_fixed):
    """Both wrappers render what JAX's do: 3DGS colours and alpha within
    1e-5; 2DGS within 2e-3 (log-space against running-product
    transmittance, as the 2DGS parity tests hold it)."""
    rng = np.random.default_rng(33)
    means, quats, scales, opac, viewmats, Ks = _scene(rng, "pinhole", N=80)
    colors = rng.uniform(0, 1, size=(80, 3)).astype(np.float32)
    args = (means, quats, scales, opac, colors, viewmats, Ks)
    kw = dict(rasterizer="packed_inference", tile_capacity=256)
    for jwrap, twrap, atol in (
            (tdgs.rendering.rasterization_inria_wrapper,
             trend.rasterization_inria_wrapper, 1e-5),
            (tdgs.rendering.rasterization_2dgs_inria_wrapper,
             trend.rasterization_2dgs_inria_wrapper, 2e-3)):
        want = jax.jit(functools.partial(jwrap, width=W, height=H, **kw))(
            *map(jnp.asarray, args))
        got = twrap(*args, W, H, device="cpu", **kw)
        assert float(got[1].max()) > 0.5
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)
    with pytest.raises(ValueError, match="0.3"):
        trend.rasterization_inria_wrapper(*args, W, H, eps2d=0.1, device="cpu")
