"""Port parity: ``tdgs_torch.rasterization`` (packed_inference, on the CPU)
against ``tdgs.rasterization`` (packed_inference, Pallas in interpret
mode) end to end.

Tolerance 2e-3 absolute, as test_packed_inference_matches_jax uses (the
log-space and cumprod prefixes round differently at the 1e-4 cutoff);
ED divides by alpha, so its depth channel is compared where alpha > 0.1."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tdgs
import tdgs_torch

ATOL = 2e-3
META_KEYS = {
    "camera_ids", "gaussian_ids", "radii", "means2d", "depths", "conics",
    "opacities", "tile_width", "tile_height", "isect_ids", "flatten_ids",
    "isect_offsets", "n_isects", "n_dropped", "width", "height", "tile_size",
    "n_batches", "n_cameras",
}


def _scene(seed, N=64, C=1):
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(N, 3)) + [0, 0, 5]).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, size=(N, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 1, size=(N,)).astype(np.float32)
    sh = (rng.normal(size=(N, 16, 3)) * 0.3).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, 0, 3] = np.linspace(-0.2, 0.2, C)
    Ks = np.tile(np.array([[60.0, 0, 32], [0, 60, 24], [0, 0, 1]], np.float32),
                 (C, 1, 1))
    return means, quats, scales, opac, sh, viewmats, Ks


@pytest.mark.parametrize(
    "render_mode,rasterize_mode,with_bg,exact",
    [
        ("RGB", "classic", False, False),
        ("RGB", "antialiased", True, False),
        ("RGB+ED", "classic", True, True),
    ],
)
def test_rasterization_matches(render_mode, rasterize_mode, with_bg, exact):
    means, quats, scales, opac, sh, viewmats, Ks = _scene(500)
    bg = np.array([[0.3, 0.5, 0.7]], np.float32) if with_bg else None
    kw = dict(sh_degree=3, render_mode=render_mode, rasterize_mode=rasterize_mode,
              tile_capacity=256, isect_exact=exact, rasterizer="packed_inference")
    want_c, want_a, want_meta = tdgs.rasterization(
        *map(jnp.asarray, (means, quats, scales, opac, sh, viewmats, Ks)), 64, 48,
        backgrounds=None if bg is None else jnp.asarray(bg), **kw,
    )
    got_c, got_a, meta = tdgs_torch.rasterization(
        means, quats, scales, opac, sh, viewmats, Ks, 64, 48,
        backgrounds=bg, device="cpu", **kw,
    )
    assert META_KEYS <= set(meta) and set(want_meta) <= set(meta) | {"isect_depths"}
    assert meta["n_isects"] == int(want_meta["n_isects"]) > 0
    assert meta["n_dropped"] == int(want_meta["n_dropped"])
    got_c, got_a = got_c.numpy(), got_a.numpy()
    want_c, want_a = np.asarray(want_c), np.asarray(want_a)
    assert got_c.shape == want_c.shape == (1, 48, 64, 4 if "+" in render_mode else 3)
    np.testing.assert_allclose(got_a, want_a, atol=ATOL)
    np.testing.assert_allclose(got_c[..., :3], want_c[..., :3], atol=ATOL)
    if render_mode == "RGB+ED":
        seen = want_a[..., 0] > 0.1
        # expected depth ~5: relative 2e-3
        np.testing.assert_allclose(got_c[..., 3][seen], want_c[..., 3][seen],
                                   rtol=2e-3)


def test_rasterization_depth_only_and_batched_cameras():
    means, quats, scales, opac, sh, viewmats, Ks = _scene(501, C=2)
    colors = sh[:, 0, :] * 0.28 + 0.5
    want_c, want_a, _ = tdgs.rasterization(
        *map(jnp.asarray, (means, quats, scales, opac, colors, viewmats, Ks)),
        64, 48, render_mode="D", rasterizer="packed_inference", tile_capacity=256,
    )
    got_c, got_a, meta = tdgs_torch.rasterization(
        means, quats, scales, opac, colors, viewmats, Ks, 64, 48,
        render_mode="D", tile_capacity=256, device="cpu",
    )
    assert meta["n_cameras"] == 2
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=ATOL)
    # accumulated depth (~5 per unit alpha)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=5 * ATOL)


# every rasterizer of the JAX package is ported, the dense jnp "eval3d" last:
# it renders, and a name the JAX package does not have raises
@pytest.mark.parametrize("rasterizer", ["eval3d"])
def test_unported_rasterizers_raise(rasterizer):
    means, quats, scales, opac, sh, viewmats, Ks = _scene(502, N=4)
    img, alpha, meta = tdgs_torch.rasterization(means, quats, scales, opac, sh[:, 0],
                                                viewmats, Ks, 64, 48, rasterizer=rasterizer,
                                                device="cpu")
    assert img.shape[-3:] == (48, 64, 3) and bool(torch.isfinite(img).all())
    with pytest.raises(ValueError, match="unknown rasterizer"):
        tdgs_torch.rasterization(means, quats, scales, opac, sh[:, 0], viewmats,
                                 Ks, 64, 48, rasterizer=rasterizer + "_dense", device="cpu")


def test_entry_point_defaults_to_cuda():
    """No device means the card; without one the call raises instead of
    moving to the CPU."""
    means, quats, scales, opac, sh, viewmats, Ks = _scene(503, N=4)
    if torch.cuda.is_available():
        _, _, meta = tdgs_torch.rasterization(means, quats, scales, opac, sh[:, 0],
                                              viewmats, Ks, 64, 48)
        assert meta["means2d"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdgs_torch.rasterization(means, quats, scales, opac, sh[:, 0],
                                     viewmats, Ks, 64, 48)
